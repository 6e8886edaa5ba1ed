"""SLAM map back-end: keyframes, landmark pools, covisibility, BA windows.

Port of ``gfplslam_tpu/models/map.py`` (``MapHandler``'s data layer,
mapHandler.cpp): KF insertion + pose composition (:113-187), KF<->map data
association (:189-772), local-map formation (:789-857), landmark culling
(:2550-2630), loop-landmark fusion (:4425-4714) and the local-BA window
(:1108-1215). The map is one ``MapState`` NamedTuple of fixed-capacity
tensors; every function returns a new state and leaves its input as it was.

The reference's ``.at[...].set(mode="drop")`` scatters go through
:func:`set_rows`, which reproduces them exactly: a negative index wraps, an
index past the end is dropped, and where several writes hit one slot the
last one wins, as in XLA's CPU scatter. ``.at[].add`` is ``index_add``
(exact here: every such sum is over integers), ``.at[].max`` is
``scatter_reduce(..., "amax")``, and ``lax.top_k`` is a stable descending
sort, so ties keep the lower index as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfplslam_torch.config import Config
from gfplslam_torch.models.ba import BAProblem
from gfplslam_torch.models.frame import StereoFrame
from gfplslam_torch.ops import camera as cam_ops
from gfplslam_torch.ops import matching as match_ops
from gfplslam_torch.ops.hamming import _popcount32, hamming_matrix
from gfplslam_torch.utils import se3

CUDA = torch.device("cuda")
CHI2_2DOF = 7.815  # 95% gate used throughout the reference (:265, :403)
DESC_HIST = 4      # recent observations kept per landmark for the medoid
# descriptor-distance caps on landmark association (mapHandler.cpp:265,
# 631-771); lines are slightly less distinctive so their cap is looser
MAX_HAMMING_PT = 80
MAX_HAMMING_LN = 96
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# scatters with the reference's semantics
# ---------------------------------------------------------------------------

def _targets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Flat int64 targets: negatives wrap, anything outside [0, n) -> n."""
    idx = idx.reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _spare(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one scratch row appended (dropped writes land there)."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def _vals(x: torch.Tensor, vals, count: int) -> torch.Tensor:
    return torch.as_tensor(vals, dtype=x.dtype, device=x.device).expand(
        count, *x.shape[1:])


def set_rows(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` along axis 0: a negative index
    wraps, one past the end is dropped, and of several writes to one row
    the last wins."""
    n = x.shape[0]
    tgt = _targets(idx, n)
    pos = torch.arange(tgt.shape[0], device=x.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=x.device
                      ).scatter_reduce(0, tgt, pos, "amax")
    tgt = torch.where(last[tgt] == pos, tgt, n)
    out = _spare(x)
    out.index_put_((tgt,), _vals(x, vals, tgt.shape[0]))
    return out[:n]


def add_rows(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].add(vals, mode="drop")`` along axis 0."""
    tgt = _targets(idx, x.shape[0])
    return _spare(x).index_add(0, tgt, _vals(x, vals, tgt.shape[0]))[:-1]


def max_rows(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].max(vals, mode="drop")`` of a 1-D tensor."""
    tgt = _targets(idx, x.shape[0])
    return _spare(x).scatter_reduce(0, tgt, _vals(x, vals, tgt.shape[0]),
                                    "amax")[:-1]


def or_rows(x: torch.Tensor, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].max(flag, mode="drop")`` of a 1-D bool tensor."""
    n = x.shape[0]
    tgt = torch.where(flag.reshape(-1), _targets(idx, n), n)
    out = _spare(x)
    out.index_put_((tgt,), torch.ones_like(tgt, dtype=torch.bool))
    return out[:n]


def top_values(key: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(key, k)[0]``: the k largest values, in descending order."""
    return torch.sort(key, descending=True, stable=True).values[:k]


def _arange(n: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def _transform(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[4, 4] transform applied to [N, 3] points."""
    return (t[:3, :3] @ x[:, :, None])[:, :, 0] + t[:3, 3]


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

class MapState(NamedTuple):
    # keyframes
    kf_pose: torch.Tensor       # [K, 4, 4] cam->world
    kf_valid: torch.Tensor      # [K] bool
    n_kf: torch.Tensor          # int32
    # point landmarks (MapPoint, mapFeatures.h:40-70)
    pt_pos: torch.Tensor        # [P, 3] world
    pt_desc: torch.Tensor       # [P, 8] int32 representative (medoid) descriptor
    pt_desc_hist: torch.Tensor  # [P, DESC_HIST, 8] int32 recent-obs ring
    pt_obs_n: torch.Tensor      # [P] int32 observation count
    pt_last_kf: torch.Tensor    # [P] int32 last observing KF
    pt_valid: torch.Tensor      # [P] bool
    # line landmarks (MapLine, mapFeatures.h:72-95)
    ln_sp: torch.Tensor         # [L, 3]
    ln_ep: torch.Tensor         # [L, 3]
    ln_desc: torch.Tensor       # [L, 8] int32
    ln_desc_hist: torch.Tensor  # [L, DESC_HIST, 8] int32
    ln_obs_n: torch.Tensor      # [L]
    ln_last_kf: torch.Tensor    # [L]
    ln_valid: torch.Tensor      # [L] bool
    # observation tables (flat, ring-allocated)
    po_kf: torch.Tensor         # [Op] int32
    po_lm: torch.Tensor         # [Op] int32
    po_uv: torch.Tensor         # [Op, 2]
    po_sigma2: torch.Tensor     # [Op]
    po_valid: torch.Tensor      # [Op] bool
    po_head: torch.Tensor       # int32 next free slot
    lo_kf: torch.Tensor         # [Ol]
    lo_lm: torch.Tensor         # [Ol]
    lo_le: torch.Tensor         # [Ol, 3]
    lo_sigma2: torch.Tensor     # [Ol]
    lo_valid: torch.Tensor      # [Ol] bool
    lo_head: torch.Tensor       # int32
    # covisibility counts (full_graph, mapHandler.h:135)
    full_graph: torch.Tensor    # [K, K] int32


def empty_map(cfg: Config, device: torch.device = CUDA) -> MapState:
    cap = cfg.cap
    k, p, l = cap.n_kf_max, cap.n_map_pt, cap.n_map_ln
    op, ol = cap.n_obs_pt * 16, cap.n_obs_ln * 16
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return MapState(
        kf_pose=torch.eye(4, **f32).repeat(k, 1, 1),
        kf_valid=torch.zeros(k, **b), n_kf=torch.zeros((), **i32),
        pt_pos=torch.zeros((p, 3), **f32), pt_desc=torch.zeros((p, 8), **i32),
        pt_desc_hist=torch.zeros((p, DESC_HIST, 8), **i32),
        pt_obs_n=torch.zeros(p, **i32), pt_last_kf=torch.zeros(p, **i32),
        pt_valid=torch.zeros(p, **b),
        ln_sp=torch.zeros((l, 3), **f32), ln_ep=torch.zeros((l, 3), **f32),
        ln_desc=torch.zeros((l, 8), **i32),
        ln_desc_hist=torch.zeros((l, DESC_HIST, 8), **i32),
        ln_obs_n=torch.zeros(l, **i32), ln_last_kf=torch.zeros(l, **i32),
        ln_valid=torch.zeros(l, **b),
        po_kf=torch.zeros(op, **i32), po_lm=torch.zeros(op, **i32),
        po_uv=torch.zeros((op, 2), **f32), po_sigma2=torch.ones(op, **f32),
        po_valid=torch.zeros(op, **b), po_head=torch.zeros((), **i32),
        lo_kf=torch.zeros(ol, **i32), lo_lm=torch.zeros(ol, **i32),
        lo_le=torch.zeros((ol, 3), **f32), lo_sigma2=torch.ones(ol, **f32),
        lo_valid=torch.zeros(ol, **b), lo_head=torch.zeros((), **i32),
        full_graph=torch.zeros((k, k), **i32))


def _update_desc_medoid(hist, rep, obs_n, lm_safe, obs_mask, new_desc):
    """Representative-descriptor refresh via a DESC_HIST-deep ring of recent
    observations + medoid selection (total-Hamming-distance minimizer over
    the buffer; updateAverageDescDir, mapFeatures.cpp:50-107). The medoid's
    popcounts are plain tensor ops, as in the reference (XLA there).

    ``obs_n`` must be the PRE-update observation count; ``lm_safe`` the
    in-range landmark id per feature; ``obs_mask`` which features observed a
    landmark this KF. Returns (hist, rep) updated."""
    p, b = hist.shape[0], hist.shape[1]
    cnt = obs_n[lm_safe]                      # [N] obs before this one
    dst = torch.where(obs_mask, lm_safe * b + cnt % b, p * b)
    hist = set_rows(hist.reshape(p * b, -1), dst, new_desc).reshape(p, b, -1)

    buf = hist[lm_safe]                       # [N, B, 8]
    occ = torch.clamp(cnt + 1, max=b)         # occupied slots 0..occ-1
    slot_ok = _arange(b, buf)[None, :] < occ[:, None]               # [N, B]
    x = (buf[:, :, None, :] ^ buf[:, None, :, :]).long() & 0xFFFFFFFF
    dist = _popcount32(x).sum(-1)                                    # [N, B, B]
    sumd = torch.where(slot_ok[:, None, :], dist, 0).sum(2)
    score = torch.where(slot_ok, sumd, _INT32_MAX)
    sel = torch.argmin(score, 1)                                     # [N]
    medoid = torch.take_along_dim(
        buf, sel[:, None, None].expand(-1, 1, buf.shape[-1]), dim=1)[:, 0]
    rep = set_rows(rep, torch.where(obs_mask, lm_safe, p), medoid)
    return hist, rep


def _alloc_slots(free_mask: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """For each True in ``want`` (feature creates a landmark), assign a free
    pool slot; -1 if the pool is exhausted. Returns [len(want)] int32."""
    n = free_mask.shape[0]
    free_idx = torch.where(free_mask, _arange(n, free_mask), n)
    free_sorted = torch.sort(free_idx).values     # free slots first
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = want & (rank < free_mask.sum()) & (rank < n)
    return torch.where(ok, free_sorted[torch.clamp(rank, 0, n - 1)], -1)


def _append_obs(kf_arr, lm_arr, uv_arr, s2_arr, valid_arr, head,
                kf_idx, lm_idx, uv, s2, want):
    """Ring-append a batch of observations at ``head`` (wraps around,
    overwriting the oldest entries — the flat analog of obs lists)."""
    cap = kf_arr.shape[0]
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.where(want, (head + rank) % cap, cap)
    kf_arr = set_rows(kf_arr, idx, kf_idx)
    lm_arr = set_rows(lm_arr, idx, lm_idx)
    uv_arr = set_rows(uv_arr, idx, uv)
    s2_arr = set_rows(s2_arr, idx, s2)
    valid_arr = set_rows(valid_arr, idx, True)
    n_new = want.sum(dtype=torch.int32)
    return kf_arr, lm_arr, uv_arr, s2_arr, valid_arr, (head + n_new) % cap


class KFMatchResult(NamedTuple):
    pt_lm_idx: torch.Tensor  # [Np] landmark id per frame point (-1 = none)
    ln_lm_idx: torch.Tensor  # [Nl]
    n_pt_matched: torch.Tensor
    n_ln_matched: torch.Tensor


def _nearest(d: torch.Tensor, valid: torch.Tensor, max_dist: int,
             n_targets: int) -> torch.Tensor:
    """Per-row best column of a gated distance matrix, capped and made
    unique per target; -1 where none."""
    dist = torch.amin(d, 1)
    mm = match_ops.Matches(idx=torch.argmin(d, 1), dist=dist,
                           valid=valid & (dist < float(1 << 16)) & (dist < max_dist))
    mm = match_ops.dedup_per_target(mm, n_targets)
    return torch.where(mm.valid, mm.idx, -1)


def _match_frame_to_map(cfg: Config, m: MapState, frame: StereoFrame,
                        t_kf_w: torch.Tensor, local_pt: torch.Tensor,
                        local_ln: torch.Tensor) -> KFMatchResult:
    """Descriptor + chi2-projection association of new-KF features to local
    landmarks (lookForCommonMatches, mapHandler.cpp:189-772)."""
    cam = cfg.camera
    t_cw = se3.inverse_se3(t_kf_w)
    big = float(1 << 16)

    # ---- points: descriptor + sigma-normalized chi2(0.95, 2dof) gate on the
    # reprojection distance (mapHandler.cpp:265) ----
    f = frame.points
    d = hamming_matrix(f.desc, m.pt_desc, f.valid,
                       m.pt_valid & local_pt).to(torch.float32)
    proj = cam_ops.project_batch(cam, _transform(t_cw, m.pt_pos))
    dx = f.xy[:, None, 0] - proj[None, :, 0]
    dy = f.xy[:, None, 1] - proj[None, :, 1]
    pd = torch.sqrt(dx * dx + dy * dy)
    d = torch.where(pd * pd * f.sigma2[:, None] < CHI2_2DOF, d, big)
    del dx, dy, pd
    pt_lm = _nearest(d, f.valid, MAX_HAMMING_PT, m.pt_pos.shape[0])
    del d

    # ---- lines: descriptor + two-endpoint distance gate to the observed
    # frame line, chi2 with 2 dof per endpoint (mapHandler.cpp:403) ----
    fl = frame.lines
    dl = hamming_matrix(fl.desc, m.ln_desc, fl.valid,
                        m.ln_valid & local_ln).to(torch.float32)
    sp2 = cam_ops.project_batch(cam, _transform(t_cw, m.ln_sp))
    ep2 = cam_ops.project_batch(cam, _transform(t_cw, m.ln_ep))
    le = fl.le

    def line_dist(p2):
        return torch.abs(le[:, None, 0] * p2[None, :, 0]
                         + le[:, None, 1] * p2[None, :, 1] + le[:, None, 2])
    dist_s = line_dist(sp2)
    dist_e = line_dist(ep2)
    geom_ok = ((dist_s * dist_s + dist_e * dist_e) * fl.sigma2[:, None]
               < 2 * CHI2_2DOF)
    del dist_s, dist_e
    ln_lm = _nearest(torch.where(geom_ok, dl, big), fl.valid, MAX_HAMMING_LN,
                     m.ln_sp.shape[0])
    return KFMatchResult(pt_lm_idx=pt_lm, ln_lm_idx=ln_lm,
                         n_pt_matched=(pt_lm >= 0).sum(),
                         n_ln_matched=(ln_lm >= 0).sum())


def local_kf_mask(cfg: Config, m: MapState, kf_idx: torch.Tensor) -> torch.Tensor:
    """Local-map KFs: covisibility >= min_lm_cov_graph with the given KF, or
    among the last min_kf_local_map KFs (formLocalMap, :789-857)."""
    k = m.kf_pose.shape[0]
    ids = _arange(k, m.kf_pose)
    kf_idx = kf_idx.long()
    covis = m.full_graph[kf_idx] + m.full_graph[:, kf_idx]
    recent = (ids <= kf_idx) & (ids > kf_idx - cfg.slam.min_kf_local_map - 1)
    return m.kf_valid & ((covis >= cfg.slam.min_lm_cov_graph) | recent)


def local_landmark_masks(cfg: Config, m: MapState, kf_idx: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Landmarks observed by any local KF."""
    kf_loc = local_kf_mask(cfg, m, kf_idx)
    pt_loc = or_rows(torch.zeros_like(m.pt_valid), m.po_lm,
                     m.po_valid & kf_loc[m.po_kf])
    ln_loc = or_rows(torch.zeros_like(m.ln_valid), m.lo_lm,
                     m.lo_valid & kf_loc[m.lo_kf])
    return pt_loc & m.pt_valid, ln_loc & m.ln_valid


def initialize_map(cfg: Config, m: MapState, frame: StereoFrame) -> MapState:
    """KF0: every stereo feature becomes a landmark (MapHandler::initialize
    path, mapHandler.cpp:37-94). World frame = KF0 camera frame."""
    dev = m.kf_pose.device
    return _insert_kf(cfg, m, frame, torch.eye(4, device=dev),
                      pt_lm_idx=torch.full((frame.points.xy.shape[0],), -1, device=dev),
                      ln_lm_idx=torch.full((frame.lines.sp.shape[0],), -1, device=dev))


def add_keyframe(cfg: Config, m: MapState, frame: StereoFrame,
                 t_rel: torch.Tensor) -> tuple[MapState, KFMatchResult]:
    """KF insertion (addKeyFrame, mapHandler.cpp:113-187): compose pose from
    the previous KF, associate features with local landmarks, create new
    landmarks from unmatched stereo features, update obs + covisibility."""
    prev_idx = m.n_kf.long() - 1
    t_kf_w = m.kf_pose[prev_idx] @ t_rel
    pt_loc, ln_loc = local_landmark_masks(cfg, m, prev_idx)
    match = _match_frame_to_map(cfg, m, frame, t_kf_w, pt_loc, ln_loc)
    m = _insert_kf(cfg, m, frame, t_kf_w, match.pt_lm_idx, match.ln_lm_idx)
    return m, match


def _insert_kf(cfg: Config, m: MapState, frame: StereoFrame,
               t_kf_w: torch.Tensor, pt_lm_idx: torch.Tensor,
               ln_lm_idx: torch.Tensor) -> MapState:
    kf_idx = m.n_kf
    m = m._replace(kf_pose=set_rows(m.kf_pose, kf_idx, t_kf_w),
                   kf_valid=set_rows(m.kf_valid, kf_idx, True))
    f = frame.points
    fl = frame.lines
    n_p, n_l = m.pt_pos.shape[0], m.ln_sp.shape[0]

    # --- create new landmarks from unmatched valid features ---
    slot_pt = _alloc_slots(~m.pt_valid, f.valid & (pt_lm_idx < 0))
    created_pt = slot_pt >= 0
    dst_p = torch.where(created_pt, slot_pt, n_p)
    # reused pool slots must not inherit a culled landmark's obs count (it
    # seeds the descriptor-history ring position)
    m = m._replace(pt_pos=set_rows(m.pt_pos, dst_p, _transform(t_kf_w, f.p3d)),
                   pt_desc=set_rows(m.pt_desc, dst_p, f.desc),
                   pt_obs_n=set_rows(m.pt_obs_n, dst_p, 0))
    slot_ln = _alloc_slots(~m.ln_valid, fl.valid & (ln_lm_idx < 0))
    created_ln = slot_ln >= 0
    dst_l = torch.where(created_ln, slot_ln, n_l)
    m = m._replace(ln_sp=set_rows(m.ln_sp, dst_l, _transform(t_kf_w, fl.sp3d)),
                   ln_ep=set_rows(m.ln_ep, dst_l, _transform(t_kf_w, fl.ep3d)),
                   ln_desc=set_rows(m.ln_desc, dst_l, fl.desc),
                   ln_obs_n=set_rows(m.ln_obs_n, dst_l, 0))

    # landmark id per feature after creation
    pt_lm = torch.where(created_pt, slot_pt, pt_lm_idx)
    ln_lm = torch.where(created_ln, slot_ln, ln_lm_idx)
    obs_pt = pt_lm >= 0
    obs_ln = ln_lm >= 0
    pt_lm_safe = torch.where(obs_pt, pt_lm, 0)
    ln_lm_safe = torch.where(obs_ln, ln_lm, 0)

    # --- covisibility increments (expandGraphs + full_graph++, :303-334):
    # for each matched (pre-existing) landmark, +1 with every KF in its obs
    matched_pt = set_rows(torch.zeros_like(m.pt_valid),
                          torch.where(pt_lm_idx >= 0, pt_lm_idx, n_p), True)
    matched_ln = set_rows(torch.zeros_like(m.ln_valid),
                          torch.where(ln_lm_idx >= 0, ln_lm_idx, n_l), True)
    inc_p = m.po_valid & matched_pt[m.po_lm]
    inc_l = m.lo_valid & matched_ln[m.lo_lm]
    k = m.full_graph.shape[0]
    row = kf_idx.long() * k
    fg = add_rows(m.full_graph.reshape(-1), row + m.po_kf, inc_p.to(torch.int32))
    fg = add_rows(fg, row + m.lo_kf, inc_l.to(torch.int32))
    m = m._replace(full_graph=fg.reshape(k, k))

    # --- append observations ---
    po = _append_obs(m.po_kf, m.po_lm, m.po_uv, m.po_sigma2, m.po_valid,
                     m.po_head, kf_idx, pt_lm_safe, f.xy, f.sigma2, obs_pt)
    lo = _append_obs(m.lo_kf, m.lo_lm, m.lo_le, m.lo_sigma2, m.lo_valid,
                     m.lo_head, kf_idx, ln_lm_safe, fl.le, fl.sigma2, obs_ln)
    m = m._replace(po_kf=po[0], po_lm=po[1], po_uv=po[2], po_sigma2=po[3],
                   po_valid=po[4], po_head=po[5],
                   lo_kf=lo[0], lo_lm=lo[1], lo_le=lo[2], lo_sigma2=lo[3],
                   lo_valid=lo[4], lo_head=lo[5])

    # --- representative descriptor refresh (see _update_desc_medoid) ---
    pt_hist, pt_desc = _update_desc_medoid(
        m.pt_desc_hist, m.pt_desc, m.pt_obs_n, pt_lm_safe, obs_pt, f.desc)
    ln_hist, ln_desc = _update_desc_medoid(
        m.ln_desc_hist, m.ln_desc, m.ln_obs_n, ln_lm_safe, obs_ln, fl.desc)
    m = m._replace(pt_desc_hist=pt_hist, pt_desc=pt_desc,
                   ln_desc_hist=ln_hist, ln_desc=ln_desc)

    # --- landmark stats + validity ---
    zero = torch.zeros((), dtype=torch.int32, device=kf_idx.device)
    return m._replace(
        pt_obs_n=add_rows(m.pt_obs_n, pt_lm_safe, obs_pt.to(torch.int32)),
        pt_last_kf=torch.maximum(m.pt_last_kf, max_rows(
            torch.zeros_like(m.pt_last_kf), pt_lm_safe,
            torch.where(obs_pt, kf_idx, zero))),
        pt_valid=set_rows(m.pt_valid, dst_p, True),
        ln_obs_n=add_rows(m.ln_obs_n, ln_lm_safe, obs_ln.to(torch.int32)),
        ln_last_kf=torch.maximum(m.ln_last_kf, max_rows(
            torch.zeros_like(m.ln_last_kf), ln_lm_safe,
            torch.where(obs_ln, kf_idx, zero))),
        ln_valid=set_rows(m.ln_valid, dst_l, True),
        n_kf=m.n_kf + 1)


def remove_bad_landmarks(cfg: Config, m: MapState) -> MapState:
    """Cull stale under-observed landmarks (removeBadMapLandmarks,
    mapHandler.cpp:2550-2630): landmarks last seen more than 10 KFs ago with
    fewer than min_lm_obs observations."""
    cur = m.n_kf - 1
    stale_pt = (m.pt_last_kf < cur - 10) & (m.pt_obs_n < cfg.slam.min_lm_obs)
    stale_ln = (m.ln_last_kf < cur - 10) & (m.ln_obs_n < cfg.slam.min_lm_obs)
    pt_valid = m.pt_valid & ~stale_pt
    ln_valid = m.ln_valid & ~stale_ln
    return m._replace(pt_valid=pt_valid, ln_valid=ln_valid,
                      po_valid=m.po_valid & pt_valid[m.po_lm],
                      lo_valid=m.lo_valid & ln_valid[m.lo_lm])


def remove_redundant_kfs(cfg: Config, m: MapState) -> tuple[MapState, torch.Tensor]:
    """Cull the single most redundant keyframe (removeRedundantKFs,
    mapHandler.cpp:2632-2795, disabled in the reference's C++ and working
    here): a KF (not KF0, not one of the last min_kf_local_map) whose
    observed landmarks carry >= 4 observations for at least
    max_common_fts_kf of its observations. Its observations are invalidated,
    landmark obs counts decremented and its covisibility row/col cleared.
    Returns (map, n_removed in {0, 1})."""
    k = m.kf_pose.shape[0]
    ids = _arange(k, m.kf_pose)
    cur = m.n_kf - 1
    redundant_p = m.po_valid & (m.pt_obs_n[m.po_lm] >= 4)
    redundant_l = m.lo_valid & (m.ln_obs_n[m.lo_lm] >= 4)
    zk = torch.zeros(k, device=m.kf_pose.device)
    per_kf_total = add_rows(add_rows(zk, m.po_kf, m.po_valid.float()),
                            m.lo_kf, m.lo_valid.float())
    per_kf_red = add_rows(add_rows(zk, m.po_kf, redundant_p.float()),
                          m.lo_kf, redundant_l.float())
    frac = per_kf_red / torch.clamp(per_kf_total, min=1.0)
    eligible = (m.kf_valid & (ids > 0)
                & (ids < cur - cfg.slam.min_kf_local_map)
                & (frac >= cfg.slam.max_common_fts_kf))
    best = torch.argmax(torch.where(eligible, frac, -1.0))
    candidate = eligible & (ids == best)

    drop_obs_p = m.po_valid & candidate[m.po_kf]
    drop_obs_l = m.lo_valid & candidate[m.lo_kf]
    keep_row = ~candidate
    return m._replace(
        kf_valid=m.kf_valid & keep_row,
        po_valid=m.po_valid & ~drop_obs_p,
        lo_valid=m.lo_valid & ~drop_obs_l,
        pt_obs_n=m.pt_obs_n - add_rows(torch.zeros_like(m.pt_obs_n), m.po_lm,
                                       drop_obs_p.to(torch.int32)),
        ln_obs_n=m.ln_obs_n - add_rows(torch.zeros_like(m.ln_obs_n), m.lo_lm,
                                       drop_obs_l.to(torch.int32)),
        full_graph=torch.where(keep_row[:, None] & keep_row[None, :],
                               m.full_graph, 0)), candidate.sum()


N_FUSE = 256  # candidate landmarks compacted per loop side for fusion


def _occupancy(rows: torch.Tensor, n: int, obs_kf: torch.Tensor,
               k: int) -> torch.Tensor:
    """[n, k] 0/1: row r holds 1 at every KF of an observation mapped to r
    (rows >= n are ignored)."""
    flat = torch.where(rows < n, rows.long() * k + obs_kf, n * k)
    return max_rows(torch.zeros(n * k, device=obs_kf.device), flat, 1.0).reshape(n, k)


def _fuse_pool(desc, pos, valid, last_kf, obs_n, obs_lm, obs_kf, obs_valid,
               kf_prev, kf_curr, near, fuse_r, n_kf_total):
    """Duplicate-landmark merge across a closed loop for one landmark family
    (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714): side A = landmarks
    last seen around ``kf_prev``, side B = landmarks from the current end;
    mutual-best descriptor match + 3D proximity gate; B merges into its A
    partner. Returns (remap [P], keep_valid [P], obs_n, last_kf, occA, occB
    [n, K] fused-pair KF occupancy, merged_mask [n], n_over_cap) with
    n = min(N_FUSE, P)."""
    p = desc.shape[0]
    n = min(N_FUSE, p)
    ids = _arange(p, desc)
    side_a = valid & (last_kf >= kf_prev - near) & (last_kf <= kf_prev + near)
    side_b = valid & (last_kf >= kf_curr - near) & ~side_a
    n_over_cap = (torch.clamp(side_a.sum() - n, min=0)
                  + torch.clamp(side_b.sum() - n, min=0))
    # compact each side to n slots by recency (landmark id breaks ties)
    a_key = top_values(torch.where(side_a, last_kf * p + ids, -1), n)
    b_key = top_values(torch.where(side_b, last_kf * p + ids, -1), n)
    a_ok = a_key >= 0
    b_ok = b_key >= 0
    a_safe = torch.where(a_ok, a_key % p, 0).long()
    b_safe = torch.where(b_ok, b_key % p, 0).long()

    d = hamming_matrix(desc[a_safe], desc[b_safe], a_ok, b_ok).to(torch.float32)
    diff = pos[a_safe][:, None, :] - pos[b_safe][None, :, :]
    gap = torch.sqrt((diff * diff).sum(-1))
    mm = match_ops.mutual_best(torch.where(gap < fuse_r, d, float(1 << 16)))
    merged = mm.valid & (mm.dist < 80) & a_ok & b_ok[mm.idx]

    keep = a_safe                                   # [n] A landmark kept
    drop = b_safe[mm.idx]                           # [n] B landmark gone
    drop_slot = torch.where(merged, drop, p)
    keep_slot = torch.where(merged, keep, p)
    drop_safe = torch.where(merged, drop, 0)

    # remap: every obs of the dropped landmark re-targets the kept one
    remap = set_rows(ids, drop_slot, keep)
    keep_valid = set_rows(valid, drop_slot, False)
    # concat stats onto the kept landmark
    obs_n_new = add_rows(obs_n, keep_slot, torch.where(merged, obs_n[drop_safe], 0))
    last_kf_new = torch.maximum(last_kf, max_rows(
        torch.zeros_like(last_kf), keep_slot,
        torch.where(merged, last_kf[drop_safe], 0)))

    # fused-pair KF occupancy for covisibility increments (:4478-4545)
    rank = _arange(n, desc)
    inv_keep = set_rows(torch.full((p + 1,), n, dtype=torch.int32,
                                   device=desc.device), keep_slot, rank)
    inv_drop = set_rows(torch.full((p + 1,), n, dtype=torch.int32,
                                   device=desc.device), drop_slot, rank)
    row_a = torch.where(obs_valid, inv_keep[obs_lm], n)
    row_b = torch.where(obs_valid, inv_drop[obs_lm], n)
    occ_a = _occupancy(row_a, n, obs_kf, n_kf_total)
    occ_b = _occupancy(row_b, n, obs_kf, n_kf_total)
    return (remap, keep_valid, obs_n_new, last_kf_new, occ_a, occ_b, merged,
            n_over_cap)


def fuse_loop_landmarks(cfg: Config, m: MapState, kf_prev: torch.Tensor,
                        kf_curr: torch.Tensor):
    """Merge duplicate landmarks across a just-closed loop
    (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714): fused observation
    tables are redirected and the covisibility graph gains the cross-loop
    counts. Returns (map, n_fused, n_over_cap); ``n_over_cap`` counts
    fusion candidates beyond the N_FUSE compaction."""
    near = cfg.slam.min_kf_local_map + 3
    fuse_r = cfg.slam.max_lm_3d_err
    k = m.full_graph.shape[0]
    (remap_p, pt_valid, pt_obs_n, pt_last_kf,
     occ_ap, occ_bp, merged_p, over_p) = _fuse_pool(
        m.pt_desc, m.pt_pos, m.pt_valid, m.pt_last_kf, m.pt_obs_n,
        m.po_lm, m.po_kf, m.po_valid, kf_prev, kf_curr, near, fuse_r, k)
    (remap_l, ln_valid, ln_obs_n, ln_last_kf,
     occ_al, occ_bl, merged_l, over_l) = _fuse_pool(
        m.ln_desc, 0.5 * (m.ln_sp + m.ln_ep), m.ln_valid, m.ln_last_kf,
        m.ln_obs_n, m.lo_lm, m.lo_kf, m.lo_valid, kf_prev, kf_curr, near,
        fuse_r, k)
    incr = occ_ap.T @ occ_bp + occ_al.T @ occ_bl
    m = m._replace(
        pt_valid=pt_valid, pt_obs_n=pt_obs_n, pt_last_kf=pt_last_kf,
        po_lm=remap_p[m.po_lm],
        ln_valid=ln_valid, ln_obs_n=ln_obs_n, ln_last_kf=ln_last_kf,
        lo_lm=remap_l[m.lo_lm],
        full_graph=m.full_graph + incr.to(torch.int32))
    return m, merged_p.sum() + merged_l.sum(), over_p + over_l


def build_local_ba_problem(cfg: Config, m: MapState, window: int = 0,
                           global_ba: bool = False):
    """Assemble the padded local-BA window for the newest KF
    (localBundleAdjustment setup, mapHandler.cpp:1108-1215).

    ``window`` overrides the window capacity; ``global_ba=True`` selects all
    valid KFs and sizes the problem to the full landmark pools and
    observation ring (globalBundleAdjustment, mapHandler.cpp:1844-1948).

    Returns (problem, window_kf_ids [Kw], window_pt_ids [Pw],
    window_ln_ids [Lw], po_src [Op], lo_src [Ol]); ``po_src``/``lo_src``
    map each problem observation to its map observation-ring slot (-1 =
    padding) for :func:`apply_ba_outliers`."""
    cap = cfg.cap
    kw = window or (cap.n_kf_max if global_ba else cap.n_kf_window)
    cur = m.n_kf - 1
    kf_loc = m.kf_valid if global_ba else local_kf_mask(cfg, m, cur)
    # newest kw local KFs -> window slots (order: oldest..newest)
    k = m.kf_pose.shape[0]
    ids = _arange(k, m.kf_pose)
    win_ids = torch.sort(top_values(torch.where(kf_loc, ids, -1), kw)).values
    win_ok = win_ids >= 0
    win_ids_safe = torch.where(win_ok, win_ids, 0)
    # global kf -> window slot map
    kf2slot = set_rows(torch.full((k,), -1, dtype=torch.int32, device=ids.device),
                       win_ids_safe,
                       torch.where(win_ok, _arange(kw, ids), -1))

    n_p, n_l = m.pt_pos.shape[0], m.ln_sp.shape[0]
    if global_ba:
        pt_loc, ln_loc = m.pt_valid, m.ln_valid
        pw, lw = n_p, n_l
    else:
        pt_loc, ln_loc = local_landmark_masks(cfg, m, cur)
        pw = min(cap.n_obs_pt // 2, n_p)
        lw = min(cap.n_obs_ln // 2, n_l)
    p_ids = top_values(torch.where(pt_loc, _arange(n_p, ids), -1), pw)
    l_ids = top_values(torch.where(ln_loc, _arange(n_l, ids), -1), lw)
    p_ok = p_ids >= 0
    l_ok = l_ids >= 0
    p_safe = torch.where(p_ok, p_ids, 0)
    l_safe = torch.where(l_ok, l_ids, 0)
    pt2slot = set_rows(torch.full((n_p,), -1, dtype=torch.int32, device=ids.device),
                       p_safe, torch.where(p_ok, _arange(pw, ids), -1))
    ln2slot = set_rows(torch.full((n_l,), -1, dtype=torch.int32, device=ids.device),
                       l_safe, torch.where(l_ok, _arange(lw, ids), -1))

    # gauge: the oldest window KF is frozen (:1119)
    first_slot = torch.argmax(win_ok.to(torch.uint8))
    kf_free = win_ok & (_arange(kw, ids) != first_slot)

    if not global_ba and cap.n_kf_frozen > 0:
        # out-of-window KFs that observe window landmarks enter as FROZEN
        # constants (mapHandler.cpp:1299-1304), most recent first
        kwf = cap.n_kf_frozen
        po_out = m.po_valid & (kf2slot[m.po_kf] < 0) & (pt2slot[m.po_lm] >= 0)
        lo_out = m.lo_valid & (kf2slot[m.lo_kf] < 0) & (ln2slot[m.lo_lm] >= 0)
        kf_has_out = or_rows(or_rows(torch.zeros_like(m.kf_valid), m.po_kf, po_out),
                             m.lo_kf, lo_out)
        fr_ids = top_values(torch.where(kf_has_out & m.kf_valid, ids, -1), kwf)
        fr_ok = fr_ids >= 0
        kf2slot = set_rows(kf2slot, torch.where(fr_ok, fr_ids, k),
                           torch.where(fr_ok, kw + _arange(kwf, ids), -1))
        win_ids = torch.cat([win_ids, fr_ids])
        win_ok = torch.cat([win_ok, fr_ok])
        win_ids_safe = torch.where(win_ok, win_ids, 0)
        kf_free = torch.cat([kf_free, torch.zeros_like(fr_ok)])

    # observation selection: kf in window (free or frozen) AND lm in window
    po_sel = m.po_valid & (kf2slot[m.po_kf] >= 0) & (pt2slot[m.po_lm] >= 0)
    lo_sel = m.lo_valid & (kf2slot[m.lo_kf] >= 0) & (ln2slot[m.lo_lm] >= 0)
    n_po, n_lo = m.po_kf.shape[0], m.lo_kf.shape[0]
    op, ol = (n_po, n_lo) if global_ba else (cap.n_obs_pt, cap.n_obs_ln)
    # free-window observations rank above frozen-KF observations
    po_pri = (kf2slot[m.po_kf] < kw).to(torch.int32)
    lo_pri = (kf2slot[m.lo_kf] < kw).to(torch.int32)
    po_rank = top_values(torch.where(po_sel, po_pri * n_po + _arange(n_po, ids), -1), op)
    lo_rank = top_values(torch.where(lo_sel, lo_pri * n_lo + _arange(n_lo, ids), -1), ol)
    po_ok = po_rank >= 0
    lo_ok = lo_rank >= 0
    po_i = torch.where(po_ok, po_rank % n_po, 0)
    lo_i = torch.where(lo_ok, lo_rank % n_lo, 0)

    prob = BAProblem(
        kf_pose=m.kf_pose[win_ids_safe], kf_free=kf_free, kf_valid=win_ok,
        pt_pos=m.pt_pos[p_safe], pt_valid=p_ok,
        ln_sp=m.ln_sp[l_safe], ln_ep=m.ln_ep[l_safe], ln_valid=l_ok,
        po_kf=kf2slot[m.po_kf[po_i]], po_lm=pt2slot[m.po_lm[po_i]],
        po_uv=m.po_uv[po_i], po_sigma2=m.po_sigma2[po_i], po_valid=po_ok,
        lo_kf=kf2slot[m.lo_kf[lo_i]], lo_lm=ln2slot[m.lo_lm[lo_i]],
        lo_le=m.lo_le[lo_i], lo_sigma2=m.lo_sigma2[lo_i], lo_valid=lo_ok)
    po_src = torch.where(po_ok, po_i, -1)
    lo_src = torch.where(lo_ok, lo_i, -1)
    return prob, win_ids, p_ids, l_ids, po_src, lo_src


def apply_ba_result(cfg: Config, m: MapState, res, win_ids, p_ids, l_ids
                    ) -> MapState:
    """Write optimized poses/landmarks back (:1689-1712)."""
    kf_dst = torch.where(win_ids >= 0, win_ids, m.kf_pose.shape[0])
    p_dst = torch.where(p_ids >= 0, p_ids, m.pt_pos.shape[0])
    l_dst = torch.where(l_ids >= 0, l_ids, m.ln_sp.shape[0])
    return m._replace(kf_pose=set_rows(m.kf_pose, kf_dst, res.kf_pose),
                      pt_pos=set_rows(m.pt_pos, p_dst, res.pt_pos),
                      ln_sp=set_rows(m.ln_sp, l_dst, res.ln_sp),
                      ln_ep=set_rows(m.ln_ep, l_dst, res.ln_ep))


def apply_ba_outliers(cfg: Config, m: MapState, res, po_src: torch.Tensor,
                      lo_src: torch.Tensor) -> MapState:
    """Delete the observations BA marked as outliers
    (mapHandler.cpp:1714-1836): invalidate their obs-ring entries, decrement
    the affected landmarks' observation counts and the covisibility pair
    counts those observations contributed."""
    k = m.full_graph.shape[0]

    def one_family(src, inlier, obs_valid, obs_lm, obs_kf, lm_obs_n, n_lm):
        cap = obs_valid.shape[0]
        out = (src >= 0) & ~inlier
        new_valid = set_rows(obs_valid, torch.where(out, src, cap), False)
        # landmark obs-count decrement
        lm_of = obs_lm[torch.where(out, src, 0)]
        obs_n = add_rows(lm_obs_n, torch.where(out, lm_of, n_lm), -1)
        # covisibility: the symmetrized pair-count loss is
        # P_prev P_prev^T - P_new P_new^T over per-landmark KF occupancy
        rows = torch.where(obs_valid, obs_lm, n_lm)
        occ_prev = _occupancy(rows, n_lm, obs_kf, k)
        occ_new = _occupancy(torch.where(new_valid, obs_lm, n_lm), n_lm, obs_kf, k)
        return new_valid, obs_n, occ_prev.T @ occ_prev - occ_new.T @ occ_new

    po_valid, pt_obs_n, dec_p = one_family(
        po_src, res.po_inlier, m.po_valid, m.po_lm, m.po_kf, m.pt_obs_n,
        m.pt_pos.shape[0])
    lo_valid, ln_obs_n, dec_l = one_family(
        lo_src, res.lo_inlier, m.lo_valid, m.lo_lm, m.lo_kf, m.ln_obs_n,
        m.ln_sp.shape[0])
    # full_graph stores each pair count in ONE orientation: subtract the
    # strictly-lower triangle of the symmetric loss (reference :759-763)
    dec = torch.tril(dec_p + dec_l, diagonal=-1).to(torch.int32)
    return m._replace(po_valid=po_valid, lo_valid=lo_valid,
                      pt_obs_n=pt_obs_n, ln_obs_n=ln_obs_n,
                      full_graph=m.full_graph - dec)
