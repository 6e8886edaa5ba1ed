"""What the SLAM drivers share: the engine's results read to the host."""

import time

import numpy as np

from slam_bench.window import Sequence, lost_frames


def result(run, s, t0: float, **fields) -> Sequence:
    """The results of engine ``s`` after ``finish()``: every frame's pose
    re-based onto the optimised keyframes, the keyframe poses, the
    closures and the lost frames; the sequence's seconds end here."""
    frames = s.all_frame_trajectory.astype(np.float64)
    kf = s.keyframe_trajectory.astype(np.float64)
    failed = lost_frames([r.accepted for r in s.vo.records],
                         run.cfg.slam.max_num_frame_loss)
    return Sequence(frames=len(frames), tracked=len(frames) - 1,
                    failed=max(failed, int(s.vo.lost)), frame_poses=frames,
                    is_kf=[r.is_kf for r in s.vo.records], kf_poses=kf,
                    kf_frames=list(s.kf_frame_ids[:len(kf)]),
                    closures=s.n_loop_closures,
                    seconds=time.perf_counter() - t0, **fields)
