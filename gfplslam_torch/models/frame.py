"""Per-frame stereo front-end: detection, stereo matching, triangulation.

Port of ``gfplslam_tpu/models/frame.py`` (``StereoFrame``,
stereoFrame.cpp:340-767, 1019-1227, 1375-1484). Both cameras run as one
batch through every detection op (the reference's ``vmap`` over cameras):
the FAST kernel launches once for level 0 of both cameras and once for
levels 1+ of both cameras, padded to the level-1 shape; the Hamming kernel
forms the points' and the lines' stereo matrices in one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gfplslam_torch.config import CameraParams, Config
from gfplslam_torch.ops import camera as cam_ops
from gfplslam_torch.ops import fast as fast_ops
from gfplslam_torch.ops import lbd as lbd_ops
from gfplslam_torch.ops import lsd as lsd_ops
from gfplslam_torch.ops import orb as orb_ops
from gfplslam_torch.ops.hamming import BIG, hamming_matrices, hamming_matrix
from gfplslam_torch.ops.matching import mutual_best
from gfplslam_torch.ops.pyramid import (build_pyramid_padded, gaussian_blur,
                                        level_shapes)
from gfplslam_torch.utils import trace
from gfplslam_torch.utils.robust import masked_median, masked_stdv_mad_nozero


class CameraFeatures(NamedTuple):
    """Detected features of one camera image (padded)."""
    pt_xy: torch.Tensor      # [Np, 2] level-0 pixel coords
    pt_level: torch.Tensor   # [Np] int32 octave
    pt_angle: torch.Tensor   # [Np] float32
    pt_desc: torch.Tensor    # [Np, 8] int32 (uint32 bit patterns)
    pt_score: torch.Tensor   # [Np]
    pt_valid: torch.Tensor   # [Np] bool
    ln_sp: torch.Tensor      # [Nl, 2]
    ln_ep: torch.Tensor      # [Nl, 2]
    ln_angle: torch.Tensor   # [Nl]
    ln_desc: torch.Tensor    # [Nl, 8] int32
    ln_valid: torch.Tensor   # [Nl] bool


class StereoPoints(NamedTuple):
    """Triangulated stereo point features (left-anchored)."""
    xy: torch.Tensor       # [Np, 2] left pixel
    disp: torch.Tensor     # [Np]
    p3d: torch.Tensor      # [Np, 3]
    desc: torch.Tensor     # [Np, 8] int32
    level: torch.Tensor    # [Np] int32
    sigma2: torch.Tensor   # [Np]
    valid: torch.Tensor    # [Np] bool


class StereoLines(NamedTuple):
    """Triangulated stereo line features."""
    sp: torch.Tensor       # [Nl, 2] left start point
    ep: torch.Tensor       # [Nl, 2]
    sdisp: torch.Tensor    # [Nl]
    edisp: torch.Tensor    # [Nl]
    sp3d: torch.Tensor     # [Nl, 3]
    ep3d: torch.Tensor     # [Nl, 3]
    le: torch.Tensor       # [Nl, 3] normalized 2D line coefficients (left)
    angle: torch.Tensor    # [Nl]
    desc: torch.Tensor     # [Nl, 8] int32
    sigma2: torch.Tensor   # [Nl]
    valid: torch.Tensor    # [Nl] bool
    cov_sp3d: torch.Tensor  # [Nl, 3, 3]
    cov_ep3d: torch.Tensor  # [Nl, 3, 3]


class StereoFrame(NamedTuple):
    """Full per-frame state (StereoFrame, stereoFrame.h:104-180)."""
    points: StereoPoints
    lines: StereoLines
    feat_l: CameraFeatures


def take(tup, i):
    """Index every leaf of a (nested) NamedTuple along its leading axis."""
    return type(tup)(*(take(x, i) if isinstance(x, tuple) else x[i]
                       for x in tup))


def _per_level(lv_imgs: torch.Tensor, cfg: Config, fast_th, slots: int,
               vh: list, vw: list):
    """FAST + keypoints + angles + BRIEF patches for a batch of same-shape
    level images [B, h, w]: one FAST launch for the whole batch."""
    score = fast_ops.fast_score_map(lv_imgs, fast_th)
    kp = fast_ops.select_keypoints(
        score, n_out=slots, cell=cfg.orb.grid_cell, per_cell=4,
        border=cfg.orb.edge_th, valid_h=vh, valid_w=vw)
    blur = gaussian_blur(lv_imgs)
    ang = orb_ops.ic_angles_dense(blur, kp.xy)
    pf = orb_ops.brief_patches(blur, kp.xy)
    return kp.xy, kp.score, kp.valid, ang, pf


def detect_point_features(pyr: torch.Tensor, cfg: Config, fast_th):
    """Pyramid [C, L, H, W] -> per-camera (pt_xy, pt_level, pt_angle,
    pt_desc, pt_score, pt_valid), each with leading [C]
    (stereoFrame.cpp:1125-1153). Level 0 runs at its true shape; levels 1+
    run as one batch padded only to the level-1 shape."""
    cap, orb_cfg = cfg.cap, cfg.orb
    ncam, nlv, h, w = pyr.shape
    dev = pyr.device
    shapes = level_shapes(h, w, nlv, orb_cfg.scale_factor)
    slots = cap.n_pt // nlv
    outs = [_per_level(pyr[:, 0], cfg, fast_th, slots,
                       [shapes[0][0]] * ncam, [shapes[0][1]] * ncam)]
    if nlv > 1:
        h1, w1 = shapes[1]
        small = pyr[:, 1:, :h1, :w1].reshape(ncam * (nlv - 1), h1, w1)
        rest = _per_level(small, cfg, fast_th, slots,
                          [s[0] for s in shapes[1:]] * ncam,
                          [s[1] for s in shapes[1:]] * ncam)
        outs.append(tuple(x.reshape(ncam, nlv - 1, *x.shape[1:])
                          for x in rest))
        outs[0] = tuple(x[:, None] for x in outs[0])
        xy, score, valid, angs, pfs = (torch.cat(p, 1) for p in zip(*outs))
    else:
        xy, score, valid, angs, pfs = (x[:, None] for x in outs[0])
    descs = orb_ops.brief_from_patches(
        pfs.reshape(ncam * nlv * slots, -1), angs.reshape(-1)
    ).reshape(ncam, nlv, slots, -1)
    scale_l = orb_cfg.scale_factor ** torch.arange(nlv, dtype=torch.float32,
                                                   device=dev)
    lvl = torch.arange(nlv, dtype=torch.int32, device=dev).repeat_interleave(
        slots)[None].expand(ncam, -1)
    pad = cap.n_pt - nlv * slots

    def flat(x):
        x = x.reshape(ncam, nlv * slots, *x.shape[3:])
        if pad:
            x = torch.nn.functional.pad(
                x, [0, 0] * (x.dim() - 2) + [0, pad])
        return x

    xy0 = flat(xy * scale_l[None, :, None, None])
    if pad:
        lvl = torch.nn.functional.pad(lvl, (0, pad))
    return xy0, lvl, flat(angs), flat(descs), flat(score), flat(valid)


def detect_line_segments(imgs: torch.Tensor, cfg: Config):
    """LSD-analog line detection only, for a batch of camera images
    [C, H, W] (detectLineFeatures detection half,
    stereoFrame.cpp:1155-1201)."""
    return lsd_ops.detect_lines(
        imgs, n_out=cfg.cap.n_ln, ang_th_deg=cfg.lsd.ang_th,
        quant=cfg.lsd.quant, min_rel_length=cfg.tracking.min_line_length)


def describe_line_segments(imgs: torch.Tensor, sp: torch.Tensor,
                           ep: torch.Tensor) -> torch.Tensor:
    """LBD description of detected segments, [C, Nl, 8] int32
    (BinaryDescriptor::compute, stereoFrame.cpp:1203-1227)."""
    desc, _ = lbd_ops.lbd_descriptors(imgs, sp, ep)
    return desc


def camera_features(cfg: Config, points, lines=None,
                    ln_desc: torch.Tensor | None = None) -> CameraFeatures:
    """Assemble :class:`CameraFeatures` from :func:`detect_point_features`'
    tuple and, when the Config has lines, :func:`detect_line_segments`' and
    :func:`describe_line_segments`' outputs."""
    xy0, lvl, angs, descs, score, valid = points
    ncam, dev = xy0.shape[0], xy0.device
    if cfg.stvo.has_lines:
        ln_sp, ln_ep, ln_angle = lines.sp, lines.ep, lines.angle
        ln_valid = lines.valid
    else:
        # points-only operating point (Config::hasLines() false): LSD/LBD
        # never run
        nl = cfg.cap.n_ln
        ln_sp = torch.zeros(ncam, nl, 2, device=dev)
        ln_ep = torch.zeros(ncam, nl, 2, device=dev)
        ln_angle = torch.zeros(ncam, nl, device=dev)
        ln_desc = torch.zeros(ncam, nl, 8, dtype=torch.int32, device=dev)
        ln_valid = torch.zeros(ncam, nl, dtype=torch.bool, device=dev)
    if not cfg.stvo.has_points:
        valid = torch.zeros_like(valid)
    return CameraFeatures(
        pt_xy=xy0, pt_level=lvl, pt_angle=angs, pt_desc=descs,
        pt_score=score, pt_valid=valid, ln_sp=ln_sp, ln_ep=ln_ep,
        ln_angle=ln_angle, ln_desc=ln_desc, ln_valid=ln_valid)


def detect_camera_features(imgs: torch.Tensor, cfg: Config, fast_th,
                           pyr: torch.Tensor) -> CameraFeatures:
    """Points (all pyramid levels) + lines for a batch of camera images
    [C, H, W]; every field has a leading [C] (stereoFrame.cpp:1019-1227)."""
    points = detect_point_features(pyr, cfg, fast_th)
    if not cfg.stvo.has_lines:
        return camera_features(cfg, points)
    lines = detect_line_segments(imgs, cfg)
    return camera_features(cfg, points, lines,
                           describe_line_segments(imgs, lines.sp, lines.ep))


def _subpixel_refine(pyr_l: torch.Tensor, pyr_r: torch.Tensor,
                     scale_factor: float, xy_l: torch.Tensor,
                     level_l: torch.Tensor, u_r0: torch.Tensor,
                     win: int = 4, search: int = 4):
    """Batched SAD parabola refinement of the right-image column
    (subPixelStereoRefine_ORBSLAM, stereoFrame.cpp:340-404) on the padded
    [L, H, W] pyramids at each point's octave, by flat element indexing.
    Returns refined level-0 right u and validity. ``win = search = 4`` by
    default (the reference uses 5/5; OrbParams.subpix_win/subpix_search)."""
    nlv, h, w = pyr_l.shape
    dev = pyr_l.device
    scales = torch.tensor(scale_factor, dtype=torch.float32, device=dev) ** \
        torch.arange(nlv, dtype=torch.float32, device=dev)
    flat_l = pyr_l.reshape(-1)
    flat_r = pyr_r.reshape(-1)
    li = torch.clamp(level_l.long(), 0, nlv - 1)
    base = (li * (h * w))[:, None, None]
    s = scales[li]
    ul = xy_l[:, 0] / s
    vl = xy_l[:, 1] / s
    ur = u_r0 / s
    dy = torch.arange(-win, win + 1, device=dev)
    yi = torch.clamp(torch.round(vl).long()[:, None] + dy, 0, h - 1)
    xi = torch.clamp(torch.round(ul).long()[:, None] + dy, 0, w - 1)
    patch_l = flat_l[base + yi[:, :, None] * w + xi[:, None, :]]   # [N, 9, 9]
    patch_l = patch_l - patch_l[:, win:win + 1, win:win + 1]
    strip_x = torch.clamp(
        torch.round(ur).long()[:, None]
        + torch.arange(-search - win, search + win + 1, device=dev), 0, w - 1)
    strip = flat_r[base + yi[:, :, None] * w + strip_x[:, None, :]]
    sad_list = []
    for k in range(2 * search + 1):
        patch_r = strip[:, :, k:k + 2 * win + 1]
        patch_r = patch_r - patch_r[:, win:win + 1, win:win + 1]
        sad_list.append(torch.abs(patch_l - patch_r).sum((1, 2)))
    sads = torch.stack(sad_list, 1)                                # [N, 2s+1]
    best = torch.argmin(sads, dim=1)
    edge = (best == 0) | (best == 2 * search)

    def sad_at(i):
        return torch.gather(sads, 1, torch.clamp(i, 0, 2 * search)[:, None])[:, 0]

    bm1, b0, bp1 = sad_at(best - 1), sad_at(best), sad_at(best + 1)
    denom = torch.clamp(bm1 + bp1 - 2 * b0, min=1e-6)
    delta = torch.clamp(0.5 * (bm1 - bp1) / denom, -1.0, 1.0)
    ur_ref = (ur + (best - search) + delta) * s
    return ur_ref, ~edge


def _point_problem(feat_l: CameraFeatures, feat_r: CameraFeatures):
    return feat_l.pt_desc, feat_r.pt_desc, feat_l.pt_valid, feat_r.pt_valid


def _line_problem(feat_l: CameraFeatures, feat_r: CameraFeatures):
    return feat_l.ln_desc, feat_r.ln_desc, feat_l.ln_valid, feat_r.ln_valid


def stereo_match_points(cam: CameraParams, cfg: Config,
                        feat_l: CameraFeatures, feat_r: CameraFeatures,
                        pyr_l: torch.Tensor, pyr_r: torch.Tensor,
                        dist: torch.Tensor | None = None) -> StereoPoints:
    """Row-banded epipolar Hamming matching + sub-pixel refine + median gate
    (extractStereoFeatures_ORBSLAM point block, stereoFrame.cpp:443-630).
    ``dist`` is the points' masked Hamming matrix where the caller already
    formed it; without it, it is formed here."""
    th_orb = 80.0  # (TH_HIGH+TH_LOW)/2, :457
    sf = cfg.orb.scale_factor
    if dist is None:
        dist = hamming_matrix(*_point_problem(feat_l, feat_r))
    d = dist.float()
    vr = feat_r.pt_xy[:, 1][None, :]
    vl = feat_l.pt_xy[:, 1][:, None]
    row_r = 2.0 * sf ** feat_r.pt_level.float()[None, :]
    row_ok = torch.abs(vr - vl) <= row_r
    oct_ok = torch.abs(feat_r.pt_level[None, :] - feat_l.pt_level[:, None]) <= 1
    ur = feat_r.pt_xy[:, 0][None, :]
    ul = feat_l.pt_xy[:, 0][:, None]
    max_d = cam.fx
    disp_ok = (ur >= ul - max_d) & (ur <= ul)  # minD=0 (:489-491)
    d = torch.where(row_ok & oct_ok & disp_ok, d, torch.full_like(d, float(BIG)))
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    ok = feat_l.pt_valid & (best_d < th_orb)

    u_r0 = feat_r.pt_xy[best, 0]
    u_ref, ref_ok = _subpixel_refine(pyr_l, pyr_r, sf, feat_l.pt_xy,
                                     feat_l.pt_level, u_r0,
                                     win=cfg.orb.subpix_win,
                                     search=cfg.orb.subpix_search)
    disp = feat_l.pt_xy[:, 0] - u_ref
    disp = torch.where(disp <= 0, torch.full_like(disp, 0.01), disp)  # :574-577
    ok &= ref_ok & (disp < max_d)

    # median-distance outlier trim: th = 1.5*1.4*median (:591-592)
    ok &= best_d < 1.5 * 1.4 * masked_median(best_d, ok)

    p3d = cam_ops.back_project_batch(cam, feat_l.pt_xy, disp)
    # per-octave inverse-variance weight sigma2 = 1/scale^(2*level)
    sigma2 = torch.tensor(sf, dtype=torch.float32, device=d.device) ** (
        -2.0 * feat_l.pt_level.float())
    return StereoPoints(xy=feat_l.pt_xy, disp=disp, p3d=p3d,
                        desc=feat_l.pt_desc, level=feat_l.pt_level,
                        sigma2=sigma2, valid=ok)


def _line_overlap(sy_l, ey_l, sy_r, ey_r):
    """Vertical-interval overlap ratio: intersection / shorter extent
    (lineSegmentOverlapStereo, stereoFrame.cpp:1343-1371)."""
    lo = torch.maximum(torch.minimum(sy_l, ey_l), torch.minimum(sy_r, ey_r))
    hi = torch.minimum(torch.maximum(sy_l, ey_l), torch.maximum(sy_r, ey_r))
    inter = torch.clamp(hi - lo, min=0.0)
    shorter = torch.minimum(torch.abs(ey_l - sy_l), torch.abs(ey_r - sy_r))
    return inter / torch.clamp(shorter, min=1e-6)


def _endpoint_cov(cam: CameraParams, u, v, disp):
    """[N] -> [N, 3, 3] analytic 3D endpoint covariance from (u, v, disp)
    noise (stereoFrame.cpp:706-759 closed form)."""
    px = u - cam.cx
    py = v - cam.cy
    f = cam.fx
    d2 = disp * disp
    c = torch.stack([
        torch.stack([d2 + 2 * px * px, 2 * px * py, 2 * f * px], -1),
        torch.stack([2 * px * py, d2 + 2 * py * py, 2 * f * py], -1),
        torch.stack([2 * f * px, 2 * f * py, 2 * f * f + 0 * d2], -1),
    ], -2)
    return c * (cam.baseline ** 2) / torch.clamp(d2 * d2, min=1e-12)[:, None, None]


def _max_eig3(m: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of symmetric [N, 3, 3] by exactly 12 power
    iterations (the reference's count; eigvalsh would move the
    line_cov_th gate)."""
    v = torch.ones(m.shape[0], 3, dtype=m.dtype, device=m.device) / float(
        np.float32(np.sqrt(np.float32(3.0))))
    for _ in range(12):
        w = (m @ v[:, :, None])[:, :, 0]
        v = w / torch.clamp(torch.sqrt((w * w).sum(-1)), min=1e-12)[:, None]
    return (v * (m @ v[:, :, None])[:, :, 0]).sum(-1)


def stereo_match_lines(cam: CameraParams, cfg: Config,
                       feat_l: CameraFeatures, feat_r: CameraFeatures,
                       dist: torch.Tensor | None = None) -> StereoLines:
    """Mutual-best LBD matching + distinctiveness gate + geometric gates +
    intersection disparity (line block, stereoFrame.cpp:632-767). ``dist``
    as in :func:`stereo_match_points`, for the lines."""
    tr = cfg.tracking
    if dist is None:
        dist = hamming_matrix(*_line_problem(feat_l, feat_r))
    d = dist.float()
    m = mutual_best(d)
    # distinctiveness: (d2 - d1) must exceed MAD(d2-d1)*desc_th_l; duplicated
    # minima count as gap 0 (knnMatch's second neighbour includes ties)
    d1 = d.amin(1)
    d2 = torch.where(d <= d1[:, None], torch.full_like(d, float("inf")), d).amin(1)
    tie = (d == d1[:, None]).sum(1) > 1
    gap = torch.where(tie | ~torch.isfinite(d2), torch.zeros_like(d1), d2 - d1)
    ok = m.valid & (gap > masked_stdv_mad_nozero(gap, m.valid) * tr.desc_th_l)

    sp_l, ep_l = feat_l.ln_sp, feat_l.ln_ep
    sp_r = feat_r.ln_sp[m.idx]
    ep_r = feat_r.ln_ep[m.idx]

    def line_coeffs(sp, ep):
        one = torch.ones_like(sp[:, :1])
        le = torch.linalg.cross(torch.cat([sp, one], 1), torch.cat([ep, one], 1),
                                dim=1)
        n = torch.sqrt(le[:, 0] ** 2 + le[:, 1] ** 2)
        return le / torch.clamp(n, min=1e-9)[:, None], le

    le_l, _ = line_coeffs(sp_l, ep_l)
    _, le_r_raw = line_coeffs(sp_r, ep_r)
    overlap = _line_overlap(sp_l[:, 1], ep_l[:, 1], sp_r[:, 1], ep_r[:, 1])
    # intersect left endpoint rows with the right line (:693-696)
    a, b2, c2 = le_r_raw[:, 0], le_r_raw[:, 1], le_r_raw[:, 2]
    a_safe = torch.where(torch.abs(a) < 1e-9, torch.full_like(a, 1e-9), a)
    disp_s = sp_l[:, 0] - (-(c2 + b2 * sp_l[:, 1]) / a_safe)
    disp_e = ep_l[:, 0] - (-(c2 + b2 * ep_l[:, 1]) / a_safe)

    ok &= (disp_s >= tr.min_disp) & (disp_e >= tr.min_disp)
    ok &= torch.abs(le_l[:, 0]) > tr.line_horiz_th
    ok &= overlap > tr.stereo_overlap_th

    sp3d = cam_ops.back_project_batch(cam, sp_l, disp_s)
    ep3d = cam_ops.back_project_batch(cam, ep_l, disp_e)
    cov_s = _endpoint_cov(cam, sp_l[:, 0], sp_l[:, 1], disp_s)
    cov_e = _endpoint_cov(cam, ep_l[:, 0], ep_l[:, 1], disp_e)
    ok &= torch.maximum(_max_eig3(cov_s), _max_eig3(cov_e)) < tr.line_cov_th

    return StereoLines(
        sp=sp_l, ep=ep_l, sdisp=disp_s, edisp=disp_e, sp3d=sp3d, ep3d=ep3d,
        le=le_l, angle=feat_l.ln_angle, desc=feat_l.ln_desc,
        sigma2=torch.ones_like(disp_s), valid=ok,
        cov_sp3d=cov_s, cov_ep3d=cov_e)


def empty_lines(cfg: Config, device: torch.device) -> StereoLines:
    """All-invalid line slots (points-only operating point)."""
    nl = cfg.cap.n_ln
    z2 = torch.zeros(nl, 2, device=device)
    z1 = torch.zeros(nl, device=device)
    z3 = torch.zeros(nl, 3, device=device)
    z33 = torch.zeros(nl, 3, 3, device=device)
    return StereoLines(
        sp=z2, ep=z2, sdisp=z1, edisp=z1, sp3d=z3, ep3d=z3, le=z3, angle=z1,
        desc=torch.zeros(nl, 8, dtype=torch.int32, device=device),
        sigma2=torch.ones(nl, device=device),
        valid=torch.zeros(nl, dtype=torch.bool, device=device),
        cov_sp3d=z33, cov_ep3d=z33)


def process_stereo_pair(img_l: torch.Tensor, img_r: torch.Tensor, cfg: Config,
                        fast_th) -> StereoFrame:
    """The whole front-end for one rectified stereo pair
    (extractStereoFeatures_ORBSLAM, stereoFrame.cpp:411-767).

    Takes [H, W] images of any dtype on the compute device (uint8 camera
    bytes cost 4x less to upload) and casts to float32 there. ``fast_th`` is
    a float or a one-element f32 tensor on that device."""
    with trace.timed("vo.frontend"):
        with trace.span("frontend.points"):
            imgs = torch.stack([img_l, img_r]).float()
            pyrs = build_pyramid_padded(imgs, cfg.orb.nlevels, cfg.orb.scale_factor)
            points = detect_point_features(pyrs, cfg, fast_th)
        if not cfg.stvo.has_lines:
            with trace.span("frontend.stereo_points"):
                feats = camera_features(cfg, points)
                feat_l, feat_r = take(feats, 0), take(feats, 1)
                pts = stereo_match_points(cfg.camera, cfg, feat_l, feat_r,
                                          pyrs[0], pyrs[1])
            return StereoFrame(points=pts, lines=empty_lines(cfg, imgs.device),
                               feat_l=feat_l)
        with trace.span("frontend.lines"):
            lines = detect_line_segments(imgs, cfg)
        with trace.span("frontend.line_desc"):
            feats = camera_features(cfg, points, lines,
                                    describe_line_segments(imgs, lines.sp, lines.ep))
            feat_l, feat_r = take(feats, 0), take(feats, 1)
        # both stereo matrices in one kernel launch
        with trace.span("frontend.stereo_hamming"):
            d_pt, d_ln = hamming_matrices([_point_problem(feat_l, feat_r),
                                           _line_problem(feat_l, feat_r)])
        with trace.span("frontend.stereo_points"):
            pts = stereo_match_points(cfg.camera, cfg, feat_l, feat_r, pyrs[0],
                                      pyrs[1], d_pt)
        with trace.span("frontend.stereo_lines"):
            lns = stereo_match_lines(cfg.camera, cfg, feat_l, feat_r, d_ln)
        return StereoFrame(points=pts, lines=lns, feat_l=feat_l)


def estimate_line_uncertainty(cam: CameraParams, cfg: Config,
                              lines: StereoLines) -> StereoLines:
    """Refresh endpoint covariances with the disparity-stdev model
    (estimateStereoUncertainty, stereoFrame.cpp:1448-1484): disparity sigma =
    ratio_disp_std * disp, or ratio_disp_std_hor * disp for near-horizontal
    lines (|le_x| <= 0.15)."""
    ratio = torch.where(torch.abs(lines.le[:, 0]) <= 0.15,
                        torch.full_like(lines.le[:, 0], cfg.stvo.ratio_disp_std_hor),
                        torch.full_like(lines.le[:, 0], cfg.stvo.ratio_disp_std))
    b, f = cam.baseline, cam.fx

    def cov_from(u, v, disp, r):
        # J = d(X,Y,Z)/d(u,v,disp) (getJacob2D_3D, stereoFrame.cpp:1375-1392)
        d = torch.clamp(disp, min=1e-6)
        z = 0.0 * d
        j = torch.stack([
            torch.stack([b / d, z, -b * (u - cam.cx) / (d * d)], -1),
            torch.stack([z, b / d, -b * (v - cam.cy) / (d * d)], -1),
            torch.stack([z, z, -f * b / (d * d)], -1),
        ], -2)
        cov_uvd = torch.diag_embed(torch.stack([1.0 + z, 1.0 + z, (r * d) ** 2],
                                               -1))
        return j @ cov_uvd @ j.transpose(-1, -2)

    cov_s = cov_from(lines.sp[:, 0], lines.sp[:, 1], lines.sdisp, ratio)
    cov_e = cov_from(lines.ep[:, 0], lines.ep[:, 1], lines.edisp, ratio)
    return lines._replace(cov_sp3d=cov_s, cov_ep3d=cov_e)
