"""Multi-sequence batch visual odometry and SLAM, optionally split over ranks.

Port of ``gfplslam_tpu/parallel/batch.py`` (the reference's batch scripts
run many sequences one after another; SURVEY.md section 7 item 7). The
reference shards a batch of stereo sequences over a device mesh
(``P(axis)``: a contiguous block of sequences per device) and ``vmap``s
the whole-sequence scan over the batch in one program. PyTorch runs one
process per rank, so here each rank of a ``torch.distributed`` group runs
``run_vo_scan`` on its contiguous block of sequences, one sequence after
another, and the results are gathered so every rank returns the whole
batch. The results are the reference's; only the launch pattern differs
(S scans of one sequence, not one scan of S).

:func:`run_slam_batch` is the same for full SLAM, which the reference runs
only one sequence at a time (``batch_script/Run_EuRoC.py``: each sequence
N times through ``plslam_mod``): each rank runs its block of sequences
through a fresh ``SLAMSystem`` each, ``run_sequence`` and ``finish``, and
the results, whose lengths differ by sequence (keyframes), are padded and
gathered with their counts. Ranks that share one card each run their own
sessions on it, so the card overlaps one session's device work with the
others' host dispatch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from gfplslam_torch.config import Config
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.models.vo import CUDA, run_vo_scan
from gfplslam_torch.parallel import multihost
from gfplslam_torch.parallel.multihost import all_gather_cat
from gfplslam_torch.utils import trace


def block(n_items: int, group=None) -> tuple[int, int]:
    """This rank's contiguous block ``[lo, hi)`` of ``n_items`` split over
    ``group`` (all of them without one); the items must split evenly, as
    the reference's mesh sharding requires."""
    if group is None:
        return 0, n_items
    n = dist.get_world_size(group)
    if n_items % n:
        raise ValueError(f"{n_items} sequences do not split evenly over {n} ranks")
    lo = dist.get_rank(group) * (n_items // n)
    return lo, lo + n_items // n


def run_vo_batch(cfg: Config, imgs_l, imgs_r, timestamps, group=None, *,
                 device: torch.device = CUDA):
    """Run VO over a batch of sequences, split over ``group``'s ranks when
    one is given (every member calls this with the whole batch).

    Args: imgs_l/imgs_r [S, T, H, W] (uint8 or float32), timestamps [S, T];
    with a group, S must be a multiple of its size (as the reference's
    mesh sharding requires). Returns (poses [S, T, 4, 4], aux dict of
    [S, T-1] diagnostics) on ``device``."""
    lo, hi = block(len(imgs_l), group)
    runs = [run_vo_scan(cfg, imgs_l[i], imgs_r[i], timestamps[i], device=device)
            for i in range(lo, hi)]
    poses = torch.stack([p for p, _ in runs])
    aux = {k: torch.stack([a[k] for _, a in runs]) for k in runs[0][1]}
    if group is None:
        return poses, aux
    return (all_gather_cat(poses, group),
            {k: all_gather_cat(v, group) for k, v in aux.items()})


class SlamBatch(NamedTuple):
    """Every sequence's results, in sequence order, on the host. The
    keyframe fields are padded to the batch's most keyframes ``K``."""
    frame_poses: torch.Tensor      # [S, T, 4, 4] float32, SLAMSystem.all_frame_trajectory
    kf_poses: torch.Tensor         # [S, K, 4, 4] float32, keyframe_trajectory; 0 past n_kf
    n_kf: torch.Tensor             # [S] int64
    kf_frames: torch.Tensor        # [S, K] int64, each keyframe's frame id; -1 past n_kf
    accepted: torch.Tensor         # [S, T] bool, per frame
    is_kf: torch.Tensor            # [S, T] bool, per frame
    n_loop_closures: torch.Tensor  # [S] int64
    lost: torch.Tensor             # [S] bool, VisualOdometry.lost at the end


def _session(slam: SLAMSystem) -> dict:
    """One finished engine's results as host tensors (keyframes unpadded)."""
    kf = torch.from_numpy(slam.keyframe_trajectory)
    recs = slam.vo.records
    return dict(frame_poses=torch.from_numpy(slam.all_frame_trajectory),
                kf_poses=kf, n_kf=torch.tensor(len(kf)),
                kf_frames=torch.tensor(slam.kf_frame_ids[:len(kf)], dtype=torch.int64),
                accepted=torch.tensor([r.accepted for r in recs]),
                is_kf=torch.tensor([r.is_kf for r in recs]),
                n_loop_closures=torch.tensor(slam.n_loop_closures),
                lost=torch.tensor(bool(slam.vo.lost)))


def _pad(rows: list, k: int, fill) -> torch.Tensor:
    """[len(rows), k, ...]: each row's leading axis padded to ``k``."""
    out = torch.full((len(rows), k) + tuple(rows[0].shape[1:]), fill, dtype=rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _stack(sessions: list, k: int) -> SlamBatch:
    cat = {f: torch.stack([x[f] for x in sessions])
           for f in SlamBatch._fields if f not in ("kf_poses", "kf_frames")}
    return SlamBatch(kf_poses=_pad([x["kf_poses"] for x in sessions], k, 0.0),
                     kf_frames=_pad([x["kf_frames"] for x in sessions], k, -1), **cat)


def _recording_mode() -> int:
    """How this rank records: 0 not, 1 the tracer alone, 2 under a profiler."""
    return 2 if trace.profiling() else int(trace.recording())


def run_slam_batch(cfg: Config, imgs_l, imgs_r, timestamps, group=None, *,
                   chunk: int = 24, device: torch.device = CUDA) -> SlamBatch:
    """Full SLAM over a batch of sequences, split over ``group``'s ranks
    when one is given (every member calls this with the whole batch).

    Args: imgs_l/imgs_r [S, T, H, W] uint8 host frames, timestamps [S, T];
    with a group, S must be a multiple of its size. Each rank runs each
    sequence of its contiguous block through a fresh ``SLAMSystem(cfg,
    device=device)``, ``run_sequence(..., chunk=chunk)`` and ``finish()``,
    one after another; the results are gathered so that every rank returns
    the whole batch (:class:`SlamBatch`).

    Each session is a ``batch.sequence`` span, the gather a
    ``batch.gather`` wait (it waits for the slowest rank). The other ranks
    record as rank 0 does (under a profiler of their own where rank 0 is
    under one, so that every rank pays its cost) and their spans and
    counters are brought to rank 0's tracer, tagged with their rank."""
    lo, hi = block(len(imgs_l), group)
    mode = _recording_mode()
    if group is not None:
        mode = multihost.first_rank_value(mode, group)
    peer = group is not None and dist.get_rank(group) != 0
    with trace.recorded_as(mode if peer else None, device):
        sessions = []
        for i in range(lo, hi):
            with trace.span("batch.sequence"):
                slam = SLAMSystem(cfg, device=device)
                slam.run_sequence(imgs_l[i], imgs_r[i], timestamps[i], chunk=chunk)
                slam.finish()
                sessions.append(_session(slam))
            trace.count("batch.sessions", 1)
            trace.count("batch.frames", len(imgs_l[i]))
        if group is None:
            return _stack(sessions, int(max(x["n_kf"] for x in sessions)))
        with trace.wait("batch.gather"):
            out = _gather(sessions, group)
        snap = trace.snapshot() if peer and mode else None
    if mode:
        _to_first_rank(snap, group)
    return out


def _gather(sessions: list, group) -> SlamBatch:
    """Every rank's sessions, in rank order: the keyframe counts first,
    then every field padded to the batch's most keyframes."""
    dev = multihost.comm_device(group)
    n_kf = all_gather_cat(torch.stack([x["n_kf"] for x in sessions]).to(dev), group)
    local = _stack(sessions, int(n_kf.max()))
    return SlamBatch(*(all_gather_cat(x.to(dev), group).cpu() for x in local))


def _to_first_rank(snap, group) -> None:
    """Each rank's tracer snapshot gathered to rank 0, which absorbs them."""
    first = multihost.first_rank(group)
    got = [None] * dist.get_world_size(group) if dist.get_rank(group) == 0 else None
    dist.gather_object(snap, got, dst=first, group=group)
    for rank, s in enumerate(got or []):
        if s is not None:
            trace.absorb(s, rank)
