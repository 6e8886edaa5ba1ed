"""``models.vo.run_vo_scan``: the whole sequence's front-end and tracking
queued on the card with no host read between frames; the poses and the
per-frame flags come back in one read at its end.

The frames are uploaded as uint8 once, at set-up: the driver hands the
engine what a replay of a recorded sequence in device memory hands it.
"""

import time

import numpy as np
import torch

from slam_bench.window import Sequence, lost_frames


def prepare(run):
    w = run.world
    run.state["inputs"] = tuple(torch.as_tensor(x, device=run.device)
                                for x in (w.left, w.right, w.ts))


def sequence(run) -> Sequence:
    from gfplslam_torch.models.vo import run_vo_scan
    imgs_l, imgs_r, ts = run.state["inputs"]
    t0 = time.perf_counter()
    poses, aux = run_vo_scan(run.cfg, imgs_l, imgs_r, ts, device=run.device)
    poses = poses.cpu().numpy().astype(np.float64)
    accepted, is_kf = (aux[k].cpu().numpy() for k in ("accepted", "is_kf"))
    n = imgs_l.shape[0]
    return Sequence(frames=n, tracked=n - 1,
                    failed=lost_frames(accepted, run.cfg.slam.max_num_frame_loss),
                    frame_poses=poses, is_kf=[True] + [bool(k) for k in is_kf],
                    seconds=time.perf_counter() - t0)
