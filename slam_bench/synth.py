"""The benchmark's traffic generator: synthetic stereo worlds with exact
ground truth, rendered into the uint8 frames every driver replays.

A frozen copy of the port's ``io/synthetic.py`` (``make_world`` and
``render_frame``, byte for byte in what they produce), so that a later
change to the program cannot move the yardstick. One addition: a
traffic's ``box_offset`` moves a textured world's occluding boxes that far
down the corridor (0, the default, is the copy's world), so that a rig
that drives forward keeps its distance from them. Two changes, neither of
which changes a byte: segments are max-blended in one ``np.maximum.at``
per camera (max is order-free, and float32 rounding is monotonic, so the
stored values equal the loop's), and each landmark's 5x5 patch is drawn
once per world instead of once per frame and camera.
``tests/test_harness_render.py`` holds the frames to hashes recorded from
the port's renderer.

Imports numpy only: render workers start in a fraction of a second.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np


class Camera(NamedTuple):
    """Rectified pinhole stereo rig."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float


SMALL_CAMERA = Camera(376, 240, 217.6, 217.6, 183.7, 126.1, 0.11)


@dataclass
class SyntheticWorld:
    cam: Camera
    points: np.ndarray      # [P, 3] world points
    seg_start: np.ndarray   # [L, 3]
    seg_end: np.ndarray     # [L, 3]
    poses: np.ndarray       # [T, 4, 4] cam->world ground truth
    timestamps: np.ndarray  # [T]
    textured: bool = False
    boxes: np.ndarray | None = None   # [B, 2, 3] min/max corners
    _patterns: dict = field(default_factory=dict, repr=False)

    def pattern(self, pi: int) -> np.ndarray:
        """Landmark ``pi``'s 5x5 patch (its own generator, seeded by its
        index, as the original draws it at every paint)."""
        if pi not in self._patterns:
            prng = np.random.default_rng(1000 + int(pi))
            pat = prng.uniform(90, 255, (5, 5)).astype(np.float32)
            pat[2, 2] = 255.0
            self._patterns[pi] = pat
        return self._patterns[pi]


def make_world(n_frames: int = 30, n_points: int = 600, n_lines: int = 60,
               seed: int = 0, cam: Camera | None = None,
               motion: str = "forward", textured: bool = False,
               laps: int = 1, box_offset: float = 0.0) -> SyntheticWorld:
    """World in a corridor [-6,6]x[-4,4]x[0,40]; the camera moves by
    ``motion``: forward / still / rotate / loop (returns exactly to its
    start) / circuit (out and back) / orbit. ``textured`` renders the
    raycast corridor with occluding boxes and exposure variation;
    ``box_offset`` adds that many metres to every box's depth."""
    rng = np.random.default_rng(seed)
    cam = cam or SMALL_CAMERA
    pts = np.stack([rng.uniform(-6, 6, n_points),
                    rng.uniform(-4, 4, n_points),
                    rng.uniform(1.0, 30.0, n_points)], 1)
    s = np.stack([rng.uniform(-6, 6, n_lines),
                  rng.uniform(-4, 4, n_lines),
                  rng.uniform(1.5, 10.0, n_lines)], 1)
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = s + d * rng.uniform(0.8, 3.0, (n_lines, 1))

    poses, ts = [], []
    for t in range(n_frames):
        if motion == "forward":
            z = 0.04 * t
            yaw = 0.002 * t
            x = 0.01 * np.sin(0.2 * t)
        elif motion == "still":
            z = yaw = x = 0.0
        elif motion == "rotate":
            z = 0.005 * t
            yaw = 0.02 * np.sin(2.0 * np.pi * t / max(n_frames - 1, 1)) * 6
            x = 0.0
        elif motion == "loop":
            phase = 2.0 * np.pi * t / max(n_frames - 1, 1)
            x = 0.6 * np.sin(phase)
            z = 0.45 * (1.0 - np.cos(phase))
            yaw = 0.04 * np.sin(phase)
        elif motion == "circuit":
            phase = 2.0 * np.pi * laps * t / max(n_frames - 1, 1)
            z = 3.0 * (1.0 - np.cos(phase))
            x = 0.8 * np.sin(phase)
            yaw = 0.15 * np.sin(phase)
        else:  # orbit
            z = 0.03 * t
            yaw = 0.01 * t
            x = 0.05 * np.sin(0.3 * t)
        c, sn = np.cos(yaw), np.sin(yaw)
        p = np.eye(4)
        p[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        p[:3, 3] = [x, 0.0, z]
        poses.append(p)
        ts.append(t / 20.0)
    boxes = None
    if textured:
        bx = []
        for i in range(3):
            cx_ = rng.uniform(-4.0, 4.0)
            cz = 4.0 + 7.0 * i + rng.uniform(0, 2.0) + box_offset
            sx, sy, sz = rng.uniform(0.6, 1.6, 3)
            cy_ = rng.uniform(-2.0, 2.0)
            bx.append([[cx_ - sx, cy_ - sy, cz - sz],
                       [cx_ + sx, cy_ + sy, cz + sz]])
        boxes = np.asarray(bx)
    return SyntheticWorld(cam=cam, points=pts, seg_start=s, seg_end=e,
                          poses=np.stack(poses), timestamps=np.asarray(ts),
                          textured=textured, boxes=boxes)


def _hash01(ix: np.ndarray, iy: np.ndarray, salt) -> np.ndarray:
    n = (ix.astype(np.int64) * 73856093
         ^ iy.astype(np.int64) * 19349663
         ^ np.asarray(salt, np.int64) * 2654435761) & 0xFFFFFFFF
    n = (n ^ (n >> 13)) * 1274126177 & 0xFFFFFFFF
    return ((n >> 8) & 0xFFFF).astype(np.float32) / 65535.0


def _value_noise2(u, v, scale: float, salt) -> np.ndarray:
    x = u / scale
    y = v / scale
    ix = np.floor(x).astype(np.int64)
    iy = np.floor(y).astype(np.int64)
    fx = (x - ix).astype(np.float32)
    fy = (y - iy).astype(np.float32)
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    n00 = _hash01(ix, iy, salt)
    n10 = _hash01(ix + 1, iy, salt)
    n01 = _hash01(ix, iy + 1, salt)
    n11 = _hash01(ix + 1, iy + 1, salt)
    return ((n00 * (1 - fx) + n10 * fx) * (1 - fy)
            + (n01 * (1 - fx) + n11 * fx) * fy)


def _surface_texture(u, v, salt) -> np.ndarray:
    return (0.5 * _value_noise2(u, v, 0.9, salt)
            + 0.3 * _value_noise2(u, v, 0.28, salt + 1)
            + 0.2 * _value_noise2(u, v, 0.08, salt + 2))


def _raycast_corridor(cam: Camera, t_wc: np.ndarray, boxes, shift: float):
    """Nearest-surface raycast of the corridor and the boxes: (image [H, W]
    float32 in [0, 255], camera-frame depth of the hit)."""
    h, w = cam.height, cam.width
    r = t_wc[:3, :3]
    o = t_wc[:3, 3].copy()
    o = o + r @ np.array([shift, 0.0, 0.0])
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    d_c = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                    np.ones_like(uu)], axis=-1)
    d_w = d_c @ r.T

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
            consider(t, hit[..., 0] + hit[..., 2],
                     hit[..., 1] - hit[..., 2], 101 + 13 * bi)

    tex = _surface_texture(best_u, best_v, best_salt)
    val = (40.0 + 150.0 * tex) / (1.0 + 0.02 * np.abs(best_t))
    return val.astype(np.float32), best_t


def _paint_segments(img: np.ndarray, segs, val: float = 255.0) -> None:
    """Anti-aliased max-blend of every segment (u0, v0, u1, v1) in one
    scatter: the samples and weights of the original's per-sample loop,
    the same float64 arithmetic, one ``np.maximum.at``."""
    h, w = img.shape
    ys, xs, vals = [], [], []
    for u0, v0, u1, v1 in segs:
        n = int(max(abs(u1 - u0), abs(v1 - v0)) * 3 + 2)
        t = np.linspace(0, 1, n)
        u = u0 + t * (u1 - u0)
        v = v0 + t * (v1 - v0)
        ui, vi = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
        fu, fv = u - ui, v - vi
        for dv, wv in ((0, 1 - fv), (1, fv)):
            for du, wu in ((0, 1 - fu), (1, fu)):
                ys.append(vi + dv)
                xs.append(ui + du)
                vals.append(val * wv * wu)
    if not ys:
        return
    y, x, v = np.concatenate(ys), np.concatenate(xs), np.concatenate(vals)
    ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    np.maximum.at(img, (y[ok], x[ok]), v[ok].astype(np.float32))


def render_frame(world: SyntheticWorld, frame_idx: int, noise: float = 2.0,
                 seed: int = 99) -> tuple[np.ndarray, np.ndarray]:
    """(img_l, img_r) float32 [H, W] at ground-truth pose ``frame_idx``."""
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
                if zi > depth[yi, xi] + 0.05:
                    continue
            ur, vr = int(round(ui)), int(round(vi))
            if 3 <= vr < h - 3 and 3 <= ur < w - 3:
                img[vr - 2:vr + 3, ur - 2:ur + 3] = world.pattern(pi)
        sc = to_cam(world.seg_start.copy(), shift)
        ec = to_cam(world.seg_end.copy(), shift)
        ok = (sc[:, 2] > 0.3) & (ec[:, 2] > 0.3)
        zs_mid = 0.5 * (sc[ok, 2] + ec[ok, 2])
        us = cam.fx * sc[ok, 0] / sc[ok, 2] + cam.cx
        vs = cam.fy * sc[ok, 1] / sc[ok, 2] + cam.cy
        ue = cam.fx * ec[ok, 0] / ec[ok, 2] + cam.cx
        ve = cam.fy * ec[ok, 1] / ec[ok, 2] + cam.cy
        segs = []
        for a, b, c, dd, zm in zip(us, vs, ue, ve, zs_mid):
            if depth is not None:
                ym = int(round(np.clip(0.5 * (b + dd), 0, h - 1)))
                xm = int(round(np.clip(0.5 * (a + c), 0, w - 1)))
                if zm > depth[ym, xm] + 0.05:
                    continue
            segs.append((a, b, c, dd))
        _paint_segments(img, segs)
        if world.textured:
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


def u8(imgs) -> np.ndarray:
    """Camera bytes: rounded, clipped, uint8."""
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def _render_u8(job):
    world, i, noise = job
    return u8(np.stack(render_frame(world, i, noise=noise)))


class World(NamedTuple):
    """A rendered world as the drivers replay it: uint8 [T, H, W] frames
    per camera, the timestamps and the ground-truth poses [T, 4, 4]."""
    left: np.ndarray
    right: np.ndarray
    ts: np.ndarray
    poses: np.ndarray


def render_world(spec: dict, cam: Camera, seed: int, workers: int | None = None
                 ) -> World:
    """Every frame of the world ``spec`` (a traffic file's ``world``) at
    ``cam`` with world seed ``seed``, rendered in a pool of spawned
    processes (each frame's noise is seeded by its index, so the frames
    equal a loop's)."""
    world = make_world(n_frames=spec["n_frames"], n_points=spec["n_points"],
                       n_lines=spec["n_lines"], seed=seed, cam=cam,
                       motion=spec["motion"], textured=spec["textured"],
                       box_offset=spec.get("box_offset", 0.0))
    n = spec["n_frames"]
    jobs = [(world, i, spec["noise"]) for i in range(n)]
    workers = workers or max(1, min(8, os.cpu_count() or 1, n // 3))
    if workers == 1:
        pairs = [_render_u8(j) for j in jobs]
    else:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            pairs = list(ex.map(_render_u8, jobs))
    frames = np.stack(pairs)
    return World(np.ascontiguousarray(frames[:, 0]), np.ascontiguousarray(frames[:, 1]),
                 world.timestamps.astype(spec.get("ts_dtype", "float64")),
                 world.poses)
