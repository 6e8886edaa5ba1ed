"""Multi-sequence batch visual odometry, optionally split over ranks.

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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gfplslam_torch.config import Config
from gfplslam_torch.models.vo import CUDA, run_vo_scan
from gfplslam_torch.parallel.multihost import all_gather_cat


def run_vo_batch(cfg: Config, imgs_l, imgs_r, timestamps, group=None, *,
                 device: torch.device = CUDA):
    """Run VO over a batch of sequences, split over ``group``'s ranks when
    one is given (every member calls this with the whole batch).

    Args: imgs_l/imgs_r [S, T, H, W] (uint8 or float32), timestamps [S, T];
    with a group, S must be a multiple of its size (as the reference's
    mesh sharding requires). Returns (poses [S, T, 4, 4], aux dict of
    [S, T-1] diagnostics) on ``device``."""
    s = len(imgs_l)
    lo, hi = 0, s
    if group is not None:
        n = dist.get_world_size(group)
        if s % n:
            raise ValueError(f"{s} sequences do not split evenly over {n} ranks")
        lo = dist.get_rank(group) * (s // n)
        hi = lo + s // n
    runs = [run_vo_scan(cfg, imgs_l[i], imgs_r[i], timestamps[i], device=device)
            for i in range(lo, hi)]
    poses = torch.stack([p for p, _ in runs])
    aux = {k: torch.stack([a[k] for _, a in runs]) for k in runs[0][1]}
    if group is None:
        return poses, aux
    return (all_gather_cat(poses, group),
            {k: all_gather_cat(v, group) for k, v in aux.items()})
