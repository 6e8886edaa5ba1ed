"""The per-keyframe mapping pipeline.

Port of ``gfplslam_tpu/models/mapping.py``: the stages of
``MapHandler::addKeyFrame`` (mapHandler.cpp:113-187) in the reference's
order — data association, local BA, landmark culling, BoW insertion, and
(with loop closure on) loop-candidate scoring + verification. The whole
step is queued on the device with no host read. ``verify_loop`` runs
speculatively on the clamped candidate (cand < 0 means "no candidate"; the
host ignores the verification then), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfplslam_torch.config import Config
from gfplslam_torch.models import ba as ba_ops
from gfplslam_torch.models import loop as loop_ops
from gfplslam_torch.models import map as map_ops
from gfplslam_torch.models.frame import take
from gfplslam_torch.utils import se3, trace


class MappingResult(NamedTuple):
    map: map_ops.MapState
    loop_state: loop_ops.LoopState
    cand: torch.Tensor          # int32 loop-candidate KF index or -1
    verification: loop_ops.LoopVerification  # for cand (speculative)
    n_pt_matched: torch.Tensor
    n_ln_matched: torch.Tensor
    ba_err: torch.Tensor
    ba_iters: torch.Tensor


def mapping_step(cfg: Config, m: map_ops.MapState, ls: loop_ops.LoopState,
                 frame, t_rel: torch.Tensor, run_ba: bool = True,
                 run_lc: bool = True,
                 cull_redundant: bool = False) -> MappingResult:
    """KF insertion + local BA + culling + BoW + LC scoring.

    Order mirrors ``MapHandler::addKeyFrame`` (mapHandler.cpp:113-187):
    lookForCommonMatches -> localBundleAdjustment -> removeBadMapLandmarks
    -> insertKFBowVectorPL -> lookForLoopCandidates.
    """
    with trace.span("mapping.step"):
        dev = t_rel.device
        with trace.span("map.add_keyframe"):
            m, match = map_ops.add_keyframe(cfg, m, frame, t_rel)
        ba_err = torch.zeros((), device=dev)
        ba_iters = torch.zeros((), dtype=torch.int32, device=dev)
        if run_ba:
            with trace.span("map.ba_problem"):
                prob, w_ids, p_ids, l_ids, po_src, lo_src = \
                    map_ops.build_local_ba_problem(cfg, m)
                if trace.recording():
                    trace.count_device("ba.obs_pt", prob.po_valid.sum())
                    trace.count_device("ba.obs_ln", prob.lo_valid.sum())
            with trace.span("ba.solve"):
                res = ba_ops.solve_ba(cfg.camera, prob,
                                      lambda0=cfg.slam.lambda_lba_lm,
                                      lambda_k=cfg.slam.lambda_lba_k,
                                      max_iters=cfg.slam.max_iters_lba)
            with trace.span("map.apply_ba"):
                m = map_ops.apply_ba_result(cfg, m, res, w_ids, p_ids, l_ids)
                # delete the observations BA marked as outliers (the reference's
                # post-BA obs deletion, mapHandler.cpp:1714-1836)
                m = map_ops.apply_ba_outliers(cfg, m, res, po_src, lo_src)
            ba_err = res.err
            ba_iters = res.iters
        with trace.span("map.cull"):
            m = map_ops.remove_bad_landmarks(cfg, m)
            if cull_redundant:
                m, _ = map_ops.remove_redundant_kfs(cfg, m)
        kf_idx = m.n_kf - 1
        with trace.span("loop.insert_bow"):
            ls = loop_ops.insert_kf_bow(cfg, ls, kf_idx, frame)
        if run_lc:
            with trace.span("loop.candidates"):
                cand = loop_ops.look_for_loop_candidates(cfg, ls, m.full_graph, kf_idx)
            with trace.span("loop.verify"):
                ver = loop_ops.verify_loop(cfg, ls, torch.clamp(cand, min=0), kf_idx)
        else:
            cand = torch.full((), -1, dtype=torch.int32, device=dev)
            ver = loop_ops.LoopVerification(
                accepted=torch.zeros((), dtype=torch.bool, device=dev),
                t_rel=torch.eye(4, device=dev),
                n_inliers=torch.zeros((), dtype=torch.int32, device=dev),
                err=torch.zeros((), device=dev))
        return MappingResult(map=m, loop_state=ls, cand=cand, verification=ver,
                             n_pt_matched=match.n_pt_matched,
                             n_ln_matched=match.n_ln_matched,
                             ba_err=ba_err, ba_iters=ba_iters)


def mapping_step_chunk(cfg: Config, m: map_ops.MapState,
                       ls: loop_ops.LoopState, frames, j: int,
                       poses: torch.Tensor, t_prev_kf: torch.Tensor,
                       run_ba: bool = True, run_lc: bool = True,
                       cull_redundant: bool = False):
    """:func:`mapping_step` fed from a chunk scan's stacked outputs: slices
    frame ``j`` and computes the KF-relative motion
    ``inv(t_prev_kf) @ poses[j]`` on the device, so a keyframe uploads
    nothing. Returns (MappingResult, t_abs) where ``t_abs`` is this KF's
    absolute scan pose — the next call's ``t_prev_kf``."""
    t_abs = poses[j]
    res = mapping_step(cfg, m, ls, take(frames, j),
                       se3.inverse_se3(t_prev_kf) @ t_abs, run_ba=run_ba,
                       run_lc=run_lc, cull_redundant=cull_redundant)
    return res, t_abs
