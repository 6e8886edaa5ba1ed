"""What one sequence of a window leaves behind, and the arithmetic that
turns a window's sequences into its end-to-end numbers."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Sequence:
    """One whole sequence through a driver, as the harness saw it."""
    frames: int                       # handed to the system (attempted)
    tracked: int                      # frames the tracker posed (frames - bootstrap)
    failed: int                       # frames the system reported lost
    frame_poses: np.ndarray           # [frames, 4, 4] cam->world, every frame
    is_kf: list                       # per frame
    latency_s: list | None = None     # per frame: handed -> pose on the host
    kf_poses: np.ndarray | None = None  # [K, 4, 4] after BA and loop closure
    kf_frames: list | None = None     # frame index of each keyframe
    closures: int | None = None
    seconds: float = 0.0              # wall time of the sequence
    traced: bool = False              # ran under the profiler


def lost_frames(accepted, max_loss: int) -> int:
    """Frames from the one at which the tracker declares the track lost
    (more than ``max_loss`` rejected frames in a row) to the end: the
    tracker's own verdict, which persists once given."""
    run = 0
    for i, ok in enumerate(accepted):
        run = 0 if ok else run + 1
        if run > max_loss:
            return len(accepted) - i
    return 0


def rate(count: float, seconds: float) -> float:
    """A rate over the whole window: all its work over all its time."""
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_latencies_ms(seqs) -> list[float]:
    return [1e3 * x for s in seqs for x in (s.latency_s or [])]
