"""Stereo visual-odometry tracker ("StVO") as pure functions on tensors.

Port of ``gfplslam_tpu/models/tracker.py`` (``StereoFrameHandler``,
stereoFrameHandler.cpp): constant-velocity prediction, hybrid cross-frame
matching, line cutting, two-stage robust pose optimization, pose-entropy
keyframe decision, adaptive FAST threshold and track-loss counting. The
tracker state is a NamedTuple of device tensors; one ``track_step`` reads
the previous state and frames and returns the new state with no host read.

Everything after the cross-frame Hamming launch (:func:`track_body`) runs
eagerly, or as a CUDA graph's capture or replay, as ``utils/cuda_graph.py``
decides.

Pose convention: ``t_cam_w`` maps camera->world, ``dt_store`` =
T_prev<-curr, the optimizer works on T_curr<-prev
(``Tfw_curr = Tfw_prev * DT_store``, stereoFrameHandler.cpp:1984-1996).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gfplslam_torch.config import Config
from gfplslam_torch.models import linecut, pose_opt
from gfplslam_torch.models.frame import StereoFrame, estimate_line_uncertainty
from gfplslam_torch.ops import camera as cam_ops
from gfplslam_torch.ops import matching as match_ops
from gfplslam_torch.ops.hamming import BIG, hamming_matrices, hamming_matrix
from gfplslam_torch.utils import cuda_graph, se3, trace
from gfplslam_torch.utils.robust import masked_stdv_mad_nozero

# entropy constant 3(1 + log 2pi) in f32 (:2315)
_LOG_2PI_ENT = float(np.float32(3.0) * (np.float32(1.0)
                                        + np.float32(np.log(2.0 * np.pi))))


class TrackerState(NamedTuple):
    """Tracker state (StereoFrameHandler members), device tensors."""
    t_cam_w: torch.Tensor          # [4,4] current frame cam->world ("Tfw")
    t_cam_w_cov: torch.Tensor      # [6,6]
    dt_store: torch.Tensor         # [4,4] T_prev<-curr of last accepted step
    dt_cov: torch.Tensor           # [6,6]
    fast_th: torch.Tensor          # scalar float32 adaptive FAST threshold
    num_frame_loss: torch.Tensor   # int32 consecutive failed frames
    frames_since_kf: torch.Tensor  # int32
    entropy_first_prev_kf: torch.Tensor  # scalar
    cov_prev_kf: torch.Tensor      # [6,6] accumulated covariance since last KF
    prev_f_is_kf: torch.Tensor     # bool


class CrossMatches(NamedTuple):
    points: pose_opt.PointMatches
    lines: pose_opt.LineMatches
    # index of the matched current-frame feature per previous-frame slot
    pt_curr_idx: torch.Tensor  # [Np] int64, -1 where unmatched
    ln_curr_idx: torch.Tensor  # [Nl] int64


class TrackOutput(NamedTuple):
    state: TrackerState
    pose: pose_opt.PoseResult
    matches: CrossMatches
    need_kf: torch.Tensor       # bool
    n_inliers_pt: torch.Tensor  # int64
    n_inliers_ln: torch.Tensor  # int64
    track_lost: torch.Tensor    # bool (num_frame_loss exceeded)


def initial_state(cfg: Config, device: torch.device) -> TrackerState:
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TrackerState(
        t_cam_w=torch.eye(4, device=device), t_cam_w_cov=torch.eye(6, device=device),
        dt_store=torch.eye(4, device=device),
        dt_cov=torch.zeros(6, 6, device=device),
        fast_th=f(float(cfg.orb.fast_th)),
        num_frame_loss=i(0), frames_since_kf=i(0),
        entropy_first_prev_kf=f(-1e9),
        cov_prev_kf=torch.zeros(6, 6, device=device),
        prev_f_is_kf=torch.tensor(True, device=device))


def _dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 2] x [M, 2] -> [N, M] Euclidean distances."""
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    return torch.sqrt(dx * dx + dy * dy)


def _point_problem(prev: StereoFrame, curr: StereoFrame):
    return prev.points.desc, curr.points.desc, prev.points.valid, curr.points.valid


def _line_problem(prev: StereoFrame, curr: StereoFrame):
    return prev.lines.desc, curr.lines.desc, prev.lines.valid, curr.lines.valid


def cross_match_points(cfg: Config, prev: StereoFrame, curr: StereoFrame,
                       dt_pred: torch.Tensor, dist: torch.Tensor | None = None):
    """Point half of crossFrameMatching_Hybrid (:451-599): Hamming matrix
    gated by search radius + 10 px projection window, best-per-target dedup,
    budget. ``dist`` is the points' masked Hamming matrix where the caller
    already formed it; without it, it is formed here."""
    p, c = prev.points, curr.points
    if dist is None:
        dist = hamming_matrix(*_point_problem(prev, curr))
    d = dist.float()
    p_curr = (dt_pred[:3, :3] @ p.p3d[:, :, None])[:, :, 0] + dt_pred[:3, 3]
    proj = cam_ops.project_batch(cfg.camera, p_curr)
    gate = ((_dist2(proj, c.xy) <= 10.0)
            & (_dist2(p.xy, c.xy) <= cfg.tracking.point_match_radius))
    dg = torch.where(gate, d, torch.full_like(d, float(BIG)))
    i1 = torch.argmin(dg, dim=1)
    d1 = torch.gather(dg, 1, i1[:, None])[:, 0]
    pm = match_ops.Matches(idx=i1, dist=d1, valid=p.valid & (d1 < float(BIG)))
    pm = match_ops.dedup_per_target(pm, c.xy.shape[0])
    pm = match_ops.budget_gate(pm, cfg.stvo.max_point_match_num)
    pts = pose_opt.PointMatches(p3d=p.p3d, obs=c.xy[pm.idx], sigma2=p.sigma2,
                                valid=pm.valid)
    return pts, torch.where(pm.valid, pm.idx, torch.full_like(pm.idx, -1))


def cross_match_lines(cfg: Config, prev: StereoFrame, curr: StereoFrame,
                      dist: torch.Tensor | None = None):
    """Line half of crossFrameMatching_Hybrid (:605-686): mutual best +
    distinctiveness (MAD) + budget-distance threshold. ``dist`` as in
    :func:`cross_match_points`, for the lines."""
    lp, lc = prev.lines, curr.lines
    if dist is None:
        dist = hamming_matrix(*_line_problem(prev, curr))
    dl = dist.float()
    lm = match_ops.mutual_best(dl)
    dl1 = dl.amin(1)
    dl2 = torch.where(dl <= dl1[:, None], torch.full_like(dl, float("inf")),
                      dl).amin(1)
    # exact-tie minima give gap 0 (knnMatch's dist_12 includes ties)
    tie = (dl == dl1[:, None]).sum(1) > 1
    gap = torch.where(tie | ~torch.isfinite(dl2), torch.zeros_like(dl1), dl2 - dl1)
    gap_th = masked_stdv_mad_nozero(gap, lm.valid) * cfg.tracking.desc_th_l
    lm = lm._replace(valid=lm.valid & (gap > gap_th))
    lm = match_ops.budget_gate(lm, cfg.stvo.max_line_match_num)
    lns = pose_opt.LineMatches(sp3d=lp.sp3d, ep3d=lp.ep3d, le_obs=lc.le[lm.idx],
                               sigma2=lp.sigma2, valid=lm.valid)
    return lns, torch.where(lm.valid, lm.idx, torch.full_like(lm.idx, -1))


def cross_hamming(prev: StereoFrame, curr: StereoFrame):
    """Both cross-frame Hamming matrices (points, lines) in one kernel
    launch."""
    with trace.span("track.cross_hamming"):
        return hamming_matrices([_point_problem(prev, curr),
                                 _line_problem(prev, curr)])


def cross_frame_matching(cfg: Config, prev: StereoFrame, curr: StereoFrame,
                         dt_pred: torch.Tensor, d_pt: torch.Tensor | None = None,
                         d_ln: torch.Tensor | None = None) -> CrossMatches:
    """Hybrid cross-frame matching (crossFrameMatching_Hybrid, :451-695).
    ``dt_pred`` is the constant-velocity T_curr<-prev used for projection;
    ``d_pt``, ``d_ln`` the cross-frame Hamming matrices, formed here when
    not given."""
    if d_pt is None:
        d_pt, d_ln = cross_hamming(prev, curr)
    with trace.span("track.cross_points"):
        pts, pt_curr_idx = cross_match_points(cfg, prev, curr, dt_pred, d_pt)
    with trace.span("track.cross_lines"):
        lns, ln_curr_idx = cross_match_lines(cfg, prev, curr, d_ln)
    return CrossMatches(points=pts, lines=lns, pt_curr_idx=pt_curr_idx,
                        ln_curr_idx=ln_curr_idx)


def _entropy(cov: torch.Tensor) -> torch.Tensor:
    """Pose entropy 3(1+log 2pi) + 0.5 log det(cov) (:2314-2329)."""
    sign, logdet = torch.linalg.slogdet(cov)
    return _LOG_2PI_ENT + 0.5 * torch.where(
        sign > 0, logdet, torch.full_like(logdet, float("nan")))


def _update_fast_th(cfg: Config, fast_th, accepted, err, n_pt, n_all):
    """Adaptive FAST threshold schedule (updateFrame_ECCV18, :868-888)."""
    tr = cfg.tracking
    lo, hi = float(tr.fast_min_th), float(tr.fast_max_th)
    inc = float(tr.fast_inc_th)
    feat = tr.fast_feat_th
    down2 = torch.clamp(fast_th - 2 * inc, min=lo)
    bad = ~accepted | (err > tr.fast_err_th)
    return torch.where(
        bad, down2,
        torch.where(n_pt < feat, down2,
        torch.where(n_all < feat * 2, torch.clamp(fast_th - inc, min=lo),
        torch.where(n_all > feat * 4, torch.clamp(fast_th + 2 * inc, max=hi),
        torch.where(n_all > feat * 3, torch.clamp(fast_th + inc, max=hi),
                    fast_th)))))


def apply_linecut(cfg: Config, prev: StereoFrame, matches: CrossMatches,
                  dt_pred: torch.Tensor) -> pose_opt.LineMatches:
    """Good-line-cutting preconditioner on the matched lines, applied before
    pose optimization (insertStereoPair :103-146 ordering)."""
    prev_lines = estimate_line_uncertainty(cfg.camera, cfg, prev.lines)
    cut = linecut.cut_lines(cfg.camera, dt_pred, matches.lines,
                            prev_lines.cov_sp3d, prev_lines.cov_ep3d,
                            matches.points, use_logdet=cfg.stvo.max_vol_line_cut)
    return linecut.apply_cut(cfg.camera, matches.lines, cut)


def track_step(cfg: Config, state: TrackerState, prev: StereoFrame,
               curr: StereoFrame, delta_t) -> TrackOutput:
    """One tracking iteration: predict, match, cut, optimize, decide KF
    (insertStereoPair -> optimizePose -> needNewKF,
    stereoFrameHandler.cpp:83-151, 1939-2030, 2309-2349). The Hamming
    launch runs eagerly; :func:`track_body` as ``utils/cuda_graph.py``
    decides."""
    with trace.timed("vo.track"):
        d_pt, d_ln = cross_hamming(prev, curr)
        delta_t = torch.as_tensor(delta_t, dtype=torch.float32,
                                  device=curr.points.xy.device)
        return cuda_graph.step(
            "track", functools.partial(track_body, cfg),
            (state, prev, curr, delta_t, d_pt, d_ln),
            settings=(cfg.stvo, cfg.tracking, cfg.optimizer, cfg.camera, cfg.slam),
            capturable=not _refuses_capture(cfg))


def track_body(cfg: Config, state: TrackerState, prev: StereoFrame,
               curr: StereoFrame, delta_t, d_pt: torch.Tensor,
               d_ln: torch.Tensor) -> TrackOutput:
    """:func:`track_step` after the cross-frame Hamming launch, whose two
    matrices it takes: matching, line cut, pose solve and state update,
    with no host read and no host-to-device copy (what a graph captures)."""
    dt_pred = se3.inverse_se3(state.dt_store)
    matches = cross_frame_matching(cfg, prev, curr, dt_pred, d_pt, d_ln)
    opt_lines = matches.lines
    if cfg.stvo.use_line_conf_cut and cfg.stvo.has_lines:
        with trace.span("track.linecut"):
            opt_lines = apply_linecut(cfg, prev, matches, dt_pred)
    with trace.span("track.pose_opt"):
        res = pose_opt.optimize_pose(cfg.camera, dt_pred, matches.points,
                                     opt_lines, cfg.optimizer, delta_t)
    with trace.span("track.finalize"):
        return finalize_track(cfg, state, matches, res)


def _refuses_capture(cfg: Config) -> bool:
    """Whether the body calls what a CUDA graph capture refuses: the
    min-eigenvalue line cut's batched ``torch.linalg.eigvalsh`` (cuSOLVER's
    batched Jacobi solver invalidates the capture)."""
    return (cfg.stvo.use_line_conf_cut and cfg.stvo.has_lines
            and not cfg.stvo.max_vol_line_cut)


def finalize_track(cfg: Config, state: TrackerState, matches: CrossMatches,
                   res: pose_opt.PoseResult) -> TrackOutput:
    """Post-optimization state update + KF decision (:1984-2030, needNewKF
    :2309-2349, updateFrame_ECCV18 :864-922)."""
    dt_store = se3.inverse_se3(res.dt)
    t_cam_w = torch.where(res.accepted, state.t_cam_w @ dt_store, state.t_cam_w)
    t_cov = torch.where(res.accepted,
                        se3.transport_cov_se3(state.t_cam_w, res.dt_cov)
                        + state.t_cam_w_cov, state.t_cam_w_cov)
    num_loss = torch.where(res.accepted, torch.zeros_like(state.num_frame_loss),
                           state.num_frame_loss + 1)

    ent_first = torch.where(state.prev_f_is_kf, _entropy(res.dt_cov),
                            state.entropy_first_prev_kf)
    cov_step = se3.transport_cov_se3(se3.inverse_se3(dt_store), res.dt_cov)
    cov_acc = state.cov_prev_kf + cov_step
    ent_ratio = _entropy(cov_acc) / ent_first
    frames_since = state.frames_since_kf + 1
    need_kf = ((frames_since > cfg.slam.max_kf_num_frames)
               | (ent_ratio < cfg.slam.min_entropy_ratio)
               | torch.isnan(ent_ratio) | torch.isinf(ent_ratio)
               | ~res.accepted)

    n_pt = res.pt_inlier.sum()
    n_ln = res.ln_inlier.sum()
    fast_th = _update_fast_th(cfg, state.fast_th, res.accepted, res.err,
                              n_pt, n_pt + n_ln)
    new_state = TrackerState(
        t_cam_w=t_cam_w, t_cam_w_cov=t_cov, dt_store=dt_store,
        dt_cov=res.dt_cov, fast_th=fast_th, num_frame_loss=num_loss,
        frames_since_kf=frames_since, entropy_first_prev_kf=ent_first,
        cov_prev_kf=cov_acc, prev_f_is_kf=torch.zeros_like(state.prev_f_is_kf))
    return TrackOutput(
        state=new_state, pose=res, matches=matches, need_kf=need_kf,
        n_inliers_pt=n_pt, n_inliers_ln=n_ln,
        track_lost=num_loss > cfg.slam.max_num_frame_loss)


def mark_keyframe(state: TrackerState) -> TrackerState:
    """Reset relative-pose bookkeeping at a new keyframe (currFrameIsKF,
    :2351-2380): poses restart relative to the KF."""
    dev = state.t_cam_w.device
    return state._replace(
        t_cam_w=torch.eye(4, device=dev), t_cam_w_cov=torch.eye(6, device=dev),
        frames_since_kf=torch.zeros_like(state.frames_since_kf),
        cov_prev_kf=torch.zeros_like(state.cov_prev_kf),
        prev_f_is_kf=torch.ones_like(state.prev_f_is_kf))
