"""Per-rank entry points for :func:`gfplslam_torch.parallel.multihost.launch`
and :func:`~gfplslam_torch.parallel.multihost.spawn_peers`.

The tests, ``apps/bench_dist_ba.py``, ``apps/batch_eval.py``, the
benchmark's batch driver and ``chip_smoke.py`` run the distributed paths
in spawned ranks through these functions: a spawned rank imports this
module and torch, never the caller's module (the test tree imports JAX).
Each takes host data, moves it to the rank's ``device``, runs on the
default group, and returns host data, the same on every rank.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _to(tree, device):
    """A NamedTuple of tensors with every leaf moved to ``device``."""
    return type(tree)(*(x.to(device) for x in tree))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_jobs(jobs) -> list:
    """Run ``[(fn, args), ...]`` in turn in one group; their results."""
    return [fn(*args) for fn, args in jobs]


def sharded_ba(cam, prob, device, max_iters: int, tol: float = 1e-5,
               reps: int = 0, group=None):
    """``solve_ba_sharded`` of a problem already partitioned for the group
    (default group when None); then ``reps`` timed repeats. Returns (the
    result on the host, [ms per LM iteration of each repeat])."""
    from gfplslam_torch.parallel.dist_ba import solve_ba_sharded
    prob = _to(prob, device)
    res = solve_ba_sharded(cam, prob, group, max_iters=max_iters, tol=tol)
    ms = []
    for _ in range(reps):
        dist.barrier(group)
        _sync(device)
        t0 = time.perf_counter()
        res = solve_ba_sharded(cam, prob, group, max_iters=max_iters, tol=tol)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0) / max_iters)
    return _to(res, "cpu"), ms


def finish_global_ba(cfg, map_state, device):
    """``SLAMSystem.finish(run_global_ba=True)`` on a system holding
    ``map_state``; returns the map after it, on the host."""
    from gfplslam_torch.models.slam import SLAMSystem
    slam = SLAMSystem(cfg, device=torch.device(device))
    slam.map = _to(map_state, device)
    slam._n_kf_host = int(map_state.n_kf)
    slam.finish(run_global_ba=True)
    return _to(slam.map, "cpu")


def vo_batch(cfg, imgs_l, imgs_r, timestamps, device):
    """``run_vo_batch`` over the default group. Returns (poses, aux on the
    host, this rank's kernel launches, seconds on the host clock)."""
    from gfplslam_torch.ops.fast import fast_score_cuda
    from gfplslam_torch.ops.hamming import hamming_cuda
    from gfplslam_torch.parallel.batch import run_vo_batch
    dist.barrier()
    fast_score_cuda.launches = hamming_cuda.launches = 0
    t0 = time.perf_counter()
    poses, aux = run_vo_batch(cfg, imgs_l, imgs_r, timestamps, dist.group.WORLD,
                              device=torch.device(device))
    _sync(device)
    secs = time.perf_counter() - t0
    launches = {"fast9_score": fast_score_cuda.launches,
                "hamming_matrix": hamming_cuda.launches}
    return poses.cpu(), {k: v.cpu() for k, v in aux.items()}, launches, secs


def slam_batch(cfg, imgs_l, imgs_r, timestamps, device, chunk: int = 24):
    """``run_slam_batch`` over the default group: the batch's results on
    the host. A peer records as rank 0 does (``run_slam_batch``)."""
    from gfplslam_torch.parallel.batch import run_slam_batch
    return run_slam_batch(cfg, imgs_l, imgs_r, timestamps, dist.group.WORLD,
                          chunk=chunk, device=torch.device(device))
