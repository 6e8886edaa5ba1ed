"""Synthetic stereo-sequence generator with exact ground truth.

Fills the role of the reference's synthetic simulators
(src/simulate_line_cut.cpp:14-60, simulate_pl_loss.cpp:9-50 fabricate random
frames with known motion) and — in this offline environment — of the EuRoC/
KITTI datasets for end-to-end trajectory tests and benchmarking: a static
world of 3D corner clusters and 3D segments is rendered into rectified
stereo pairs along a smooth ground-truth trajectory.

Rendering is deliberately simple (painted blobs + 1px bright segments on a
textured background): enough structure for FAST/LSD to fire while keeping
generation fast on host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gfplslam_torch.config import CameraParams


@dataclass
class SyntheticWorld:
    cam: CameraParams
    points: np.ndarray     # [P, 3] world points
    seg_start: np.ndarray  # [L, 3]
    seg_end: np.ndarray    # [L, 3]
    poses: np.ndarray      # [T, 4, 4] cam->world ground truth
    timestamps: np.ndarray  # [T]
    # textured rendering: raycast corridor walls with procedural texture,
    # occluding boxes, per-frame exposure variation (the higher-realism
    # evidence tier; plain worlds keep the fast painted-blob renderer)
    textured: bool = False
    boxes: np.ndarray | None = None   # [B, 2, 3] min/max corners


def make_world(n_frames: int = 30, n_points: int = 600, n_lines: int = 60,
               seed: int = 0, cam: CameraParams | None = None,
               motion: str = "forward",
               textured: bool = False, laps: int = 1) -> SyntheticWorld:
    """World in a corridor [-6,6]x[-4,4]x[0,40]; camera advances with gentle
    yaw so features flow but remain visible. ``motion``: forward / still /
    loop (closed revisit circuit) / orbit / rotate (rotation-dominant pan).
    ``textured=True`` switches rendering to the raycast corridor with
    procedural wall texture, occluding boxes, and exposure variation."""
    rng = np.random.default_rng(seed)
    cam = cam or CameraParams(width=376, height=240,
                              fx=217.6, fy=217.6, cx=183.7, cy=126.1,
                              baseline=0.11)
    pts = np.stack([rng.uniform(-6, 6, n_points),
                    rng.uniform(-4, 4, n_points),
                    rng.uniform(1.0, 30.0, n_points)], 1)
    # lines stay near enough that endpoint disparity is measurable — the
    # reference's line_cov_th legitimately rejects lines with sub-3px
    # disparity (stereoFrame.cpp:706-759)
    s = np.stack([rng.uniform(-6, 6, n_lines),
                  rng.uniform(-4, 4, n_lines),
                  rng.uniform(1.5, 10.0, n_lines)], 1)
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = s + d * rng.uniform(0.8, 3.0, (n_lines, 1))

    poses = []
    ts = []
    for t in range(n_frames):
        if motion == "forward":
            z = 0.04 * t
            yaw = 0.002 * t
            x = 0.01 * np.sin(0.2 * t)
        elif motion == "still":
            z = yaw = x = 0.0
        elif motion == "rotate":
            # rotation-dominant pan: the hard case for translation-only
            # parallax assumptions (feature flow without baseline growth)
            z = 0.005 * t
            yaw = 0.02 * np.sin(2.0 * np.pi * t / max(n_frames - 1, 1)) * 6
            x = 0.0
        elif motion == "loop":
            # closed circuit returning exactly to the start pose — the
            # revisit world for loop-closure tests (the analog of the
            # reference's EuRoC/KITTI looping batch runs,
            # batch_script/Run_EuRoC.py): camera keeps facing +z so the
            # same scene is visible at departure and return
            phase = 2.0 * np.pi * t / max(n_frames - 1, 1)
            x = 0.6 * np.sin(phase)
            z = 0.45 * (1.0 - np.cos(phase))
            yaw = 0.04 * np.sin(phase)
        elif motion == "circuit":
            # out-and-back revisit: the camera advances ~6 m down the
            # corridor with yaw sweep, then returns exactly to the start
            # pose. Unlike "loop" (a sub-metre wiggle where every frame
            # sees the same scene and BoW rows alias to ~1.0), the middle
            # of this trajectory views genuinely different texture/boxes,
            # so a revisit is discriminative — the place-recognition
            # regime the reference's LC gates assume (mapHandler.cpp:3002).
            # ``laps`` > 1 repeats the circuit for multi-revisit sequences
            # (retrieval PR evaluation needs many aliased re-passes).
            phase = 2.0 * np.pi * laps * t / max(n_frames - 1, 1)
            z = 3.0 * (1.0 - np.cos(phase))
            x = 0.8 * np.sin(phase)
            yaw = 0.15 * np.sin(phase)
        else:  # orbit
            z = 0.03 * t
            yaw = 0.01 * t
            x = 0.05 * np.sin(0.3 * t)
        c, sn = np.cos(yaw), np.sin(yaw)
        r = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        p = np.eye(4)
        p[:3, :3] = r
        p[:3, 3] = [x, 0.0, z]
        poses.append(p)
        ts.append(t / 20.0)
    boxes = None
    if textured:
        # occluding boxes along the corridor sides (never on the camera
        # path); their faces occlude landmarks behind them and their edges
        # feed LSD with real structure
        bx = []
        for i in range(3):
            cx_ = rng.uniform(-4.0, 4.0)
            cz = 4.0 + 7.0 * i + rng.uniform(0, 2.0)
            sx, sy, sz = rng.uniform(0.6, 1.6, 3)
            cy_ = rng.uniform(-2.0, 2.0)
            bx.append([[cx_ - sx, cy_ - sy, cz - sz],
                       [cx_ + sx, cy_ + sy, cz + sz]])
        boxes = np.asarray(bx)
    return SyntheticWorld(cam=cam, points=pts, seg_start=s, seg_end=e,
                          poses=np.stack(poses), timestamps=np.asarray(ts),
                          textured=textured, boxes=boxes)


# ---------------------------------------------------------------------------
# textured renderer: raycast corridor + procedural texture + occlusion
# ---------------------------------------------------------------------------

def _hash01(ix: np.ndarray, iy: np.ndarray, salt) -> np.ndarray:
    """Deterministic integer-lattice hash -> [0, 1) floats. ``salt`` may be
    a scalar or a per-pixel array (surface id)."""
    n = (ix.astype(np.int64) * 73856093
         ^ iy.astype(np.int64) * 19349663
         ^ np.asarray(salt, np.int64) * 2654435761) & 0xFFFFFFFF
    n = (n ^ (n >> 13)) * 1274126177 & 0xFFFFFFFF
    return ((n >> 8) & 0xFFFF).astype(np.float32) / 65535.0


def _value_noise2(u: np.ndarray, v: np.ndarray, scale: float,
                  salt: int) -> np.ndarray:
    """Bilinear value noise over a 2D surface parameterization."""
    x = u / scale
    y = v / scale
    ix = np.floor(x).astype(np.int64)
    iy = np.floor(y).astype(np.int64)
    fx = (x - ix).astype(np.float32)
    fy = (y - iy).astype(np.float32)
    fx = fx * fx * (3 - 2 * fx)   # smoothstep
    fy = fy * fy * (3 - 2 * fy)
    n00 = _hash01(ix, iy, salt)
    n10 = _hash01(ix + 1, iy, salt)
    n01 = _hash01(ix, iy + 1, salt)
    n11 = _hash01(ix + 1, iy + 1, salt)
    return ((n00 * (1 - fx) + n10 * fx) * (1 - fy)
            + (n01 * (1 - fx) + n11 * fx) * fy)


def _surface_texture(u: np.ndarray, v: np.ndarray, salt: int) -> np.ndarray:
    """Multi-octave procedural texture in [0, 1]: enough gradient content
    for FAST corners and BRIEF discrimination at every wall distance."""
    t = (0.5 * _value_noise2(u, v, 0.9, salt)
         + 0.3 * _value_noise2(u, v, 0.28, salt + 1)
         + 0.2 * _value_noise2(u, v, 0.08, salt + 2))
    return t


def _raycast_corridor(cam: CameraParams, t_wc: np.ndarray,
                      boxes: np.ndarray | None, shift: float
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel nearest-surface raycast of the corridor walls (+floor,
    ceiling, far wall) and occluder boxes.

    Returns (image [H, W] float32 in [0, 255], depth [H, W] camera-frame z
    of the hit surface) — the depth buffer gives feature occlusion."""
    h, w = cam.height, cam.width
    r = t_wc[:3, :3]
    o = t_wc[:3, 3].copy()
    o = o + r @ np.array([shift, 0.0, 0.0])  # right camera offset
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    d_c = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                    np.ones_like(uu)], axis=-1)           # [H, W, 3]
    d_w = d_c @ r.T                                        # [H, W, 3]

    big = np.float32(1e9)
    best_t = np.full((h, w), big, np.float32)
    best_u = np.zeros((h, w), np.float32)
    best_v = np.zeros((h, w), np.float32)
    best_salt = np.zeros((h, w), np.int64)

    def consider(t, surf_u, surf_v, salt):
        nonlocal best_t, best_u, best_v, best_salt
        ok = t < best_t
        best_u = np.where(ok, surf_u, best_u)
        best_v = np.where(ok, surf_v, best_v)
        best_salt = np.where(ok, np.int64(salt), best_salt)
        best_t = np.where(ok, t, best_t)

    z_far = o[2] + 45.0
    # (axis, plane coordinate, u-axis, v-axis, salt)
    planes = [(0, -6.0, 2, 1, 11), (0, 6.0, 2, 1, 23),
              (1, -4.0, 0, 2, 37), (1, 4.0, 0, 2, 53),
              (2, z_far, 0, 1, 71)]
    for axis, coord, ua, va, salt in planes:
        dn = d_w[..., axis]
        t = np.where(np.abs(dn) > 1e-9, (coord - o[axis]) / dn, big)
        t = np.where(t > 0.05, t, big)
        hit = o[None, None, :] + t[..., None] * d_w
        consider(t, hit[..., ua], hit[..., va], salt)

    if boxes is not None:
        inv_d = np.where(np.abs(d_w) > 1e-9, 1.0 / d_w, big)
        for bi, (mn, mx) in enumerate(boxes):
            t0 = (mn[None, None, :] - o[None, None, :]) * inv_d
            t1 = (mx[None, None, :] - o[None, None, :]) * inv_d
            tmin = np.minimum(t0, t1).max(axis=-1)
            tmax = np.maximum(t0, t1).min(axis=-1)
            t = np.where((tmax > tmin) & (tmin > 0.05), tmin, big)
            hit = o[None, None, :] + t[..., None] * d_w
            # parameterize box texture by two world coords (cheap, seamless
            # enough for corner/edge response)
            consider(t, hit[..., 0] + hit[..., 2],
                     hit[..., 1] - hit[..., 2], 101 + 13 * bi)

    # texture only the WINNING surface per pixel (one multi-octave eval
    # instead of one per surface); distance shading keeps far walls dimmer
    tex = _surface_texture(best_u, best_v, best_salt)
    val = (40.0 + 150.0 * tex) / (1.0 + 0.02 * np.abs(best_t))
    # ray parameterization uses d_c with z == 1, so the camera-frame z of
    # the hit point is exactly t
    return val.astype(np.float32), best_t


def _paint_point(img, u, v, pattern):
    """Paint a unique 5x5 texture patch per landmark so descriptors are
    discriminative (identical blobs make BRIEF matching ambiguous)."""
    h, w = img.shape
    ui, vi = int(round(u)), int(round(v))
    if 3 <= vi < h - 3 and 3 <= ui < w - 3:
        img[vi - 2:vi + 3, ui - 2:ui + 3] = pattern


def _paint_segment(img, u0, v0, u1, v1, val=255.0):
    """Anti-aliased max-blend painting: keeps the gradient orientation
    smooth along the segment so the angle-aligned region grower can chain
    the support pixels."""
    h, w = img.shape
    n = int(max(abs(u1 - u0), abs(v1 - v0)) * 3 + 2)
    for t in np.linspace(0, 1, n):
        u = u0 + t * (u1 - u0)
        v = v0 + t * (v1 - v0)
        ui, vi = int(np.floor(u)), int(np.floor(v))
        fu, fv = u - ui, v - vi
        for dv, wv in ((0, 1 - fv), (1, fv)):
            for du, wu in ((0, 1 - fu), (1, fu)):
                y, x = vi + dv, ui + du
                if 0 <= y < h and 0 <= x < w:
                    img[y, x] = max(img[y, x], val * wv * wu)


def render_frame(world: SyntheticWorld, frame_idx: int, noise: float = 2.0,
                 seed: int = 99) -> tuple[np.ndarray, np.ndarray]:
    """Render (img_l, img_r) float32 [H, W] for ground-truth pose i."""
    cam = world.cam
    h, w = cam.height, cam.width
    rng = np.random.default_rng(seed + frame_idx * 7919)
    t_wc = world.poses[frame_idx]
    r_cw = t_wc[:3, :3].T
    t_cw = -r_cw @ t_wc[:3, 3]

    def to_cam(p, baseline_shift=0.0):
        q = p @ r_cw.T + t_cw
        q[:, 0] -= baseline_shift
        return q

    imgs = []
    for shift in (0.0, cam.baseline):
        depth = None
        if world.textured:
            img, depth = _raycast_corridor(cam, t_wc, world.boxes, shift)
        else:
            img = rng.uniform(20, 60, size=(h, w)).astype(np.float32)
            # smooth the noise so it doesn't trigger FAST
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
                   + np.roll(img, (1, 1), (0, 1))) / 4.0
        pc = to_cam(world.points.copy(), shift)
        vis = np.nonzero(pc[:, 2] > 0.3)[0]
        u = cam.fx * pc[vis, 0] / pc[vis, 2] + cam.cx
        v = cam.fy * pc[vis, 1] / pc[vis, 2] + cam.cy
        for pi, ui, vi, zi in zip(vis, u, v, pc[vis, 2]):
            if depth is not None:
                yi, xi = int(round(vi)), int(round(ui))
                if not (0 <= yi < h and 0 <= xi < w):
                    continue
                if zi > depth[yi, xi] + 0.05:   # occluded by wall/box
                    continue
            prng = np.random.default_rng(1000 + int(pi))
            pattern = prng.uniform(90, 255, (5, 5)).astype(np.float32)
            pattern[2, 2] = 255.0
            _paint_point(img, ui, vi, pattern)
        sc = to_cam(world.seg_start.copy(), shift)
        ec = to_cam(world.seg_end.copy(), shift)
        ok = (sc[:, 2] > 0.3) & (ec[:, 2] > 0.3)
        zs_mid = 0.5 * (sc[ok, 2] + ec[ok, 2])
        us = cam.fx * sc[ok, 0] / sc[ok, 2] + cam.cx
        vs = cam.fy * sc[ok, 1] / sc[ok, 2] + cam.cy
        ue = cam.fx * ec[ok, 0] / ec[ok, 2] + cam.cx
        ve = cam.fy * ec[ok, 1] / ec[ok, 2] + cam.cy
        for a, b, c, dd, zm in zip(us, vs, ue, ve, zs_mid):
            if depth is not None:
                ym = int(round(np.clip(0.5 * (b + dd), 0, h - 1)))
                xm = int(round(np.clip(0.5 * (a + c), 0, w - 1)))
                if zm > depth[ym, xm] + 0.05:   # midpoint occluded
                    continue
            _paint_segment(img, a, b, c, dd)
        if world.textured:
            # photometric variation: per-frame exposure gain/bias and a
            # radial vignette (EuRoC-like auto-exposure behavior)
            gain = rng.uniform(0.88, 1.12)
            bias = rng.uniform(-8.0, 8.0)
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            r2 = (((xx - w / 2) / (w / 2)) ** 2
                  + ((yy - h / 2) / (h / 2)) ** 2)
            img = img * gain * (1.0 - 0.18 * r2.astype(np.float32)) + bias
        if noise > 0:
            img += rng.normal(0, noise, size=(h, w)).astype(np.float32)
        imgs.append(np.clip(img, 0, 255).astype(np.float32))
    return imgs[0], imgs[1]
