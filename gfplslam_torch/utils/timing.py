"""Per-frame, per-module timing log (TimeLog parity, stereoFrame.h:66-86).

The reference records wall time + feature counts per pipeline stage and dumps
one row per frame to ``<out>_Log.txt`` (plslam_mod.cpp:494-513). Metric names
are kept identical so BASELINE comparisons hold. The port queues a whole
frame with no host read, so by default ``VisualOdometry`` fills only
``time_pt_extract`` and ``time_pose_optim``, with the host time of the
``vo.frontend`` and ``vo.track`` spans; when the tracer synchronises every
span (``utils/trace.py``, ``run_slam --timing``) each stage field is the sum
of the stage spans :data:`STAGE_SPANS` names for it (in that mode no step
runs as a CUDA graph's replay, so every stage has its own span).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

FIELDS = [
    "time_track", "time_pt_extract", "time_ln_detect", "time_ln_descri",
    "time_pt_stereo", "time_ln_stereo", "time_pt_cross", "time_ln_cross",
    "time_ln_cut", "time_pose_optim",
    "num_pt_stereo", "num_ln_stereo", "num_pt_cross", "num_ln_cross",
]

# each stage field of the TimeLog -> the spans of the served path it sums
# (the paired Hamming launches fall to the points' fields, which use them
# first); ``time_track`` is the sum of these nine
STAGE_SPANS = {
    "time_pt_extract": ("frontend.points",),
    "time_ln_detect": ("frontend.lines",),
    "time_ln_descri": ("frontend.line_desc",),
    "time_pt_stereo": ("frontend.stereo_hamming", "frontend.stereo_points"),
    "time_ln_stereo": ("frontend.stereo_lines",),
    "time_pt_cross": ("track.cross_hamming", "track.cross_points"),
    "time_ln_cross": ("track.cross_lines",),
    "time_ln_cut": ("track.linecut",),
    "time_pose_optim": ("track.pose_opt", "track.finalize"),
}


@dataclass
class TimeLog:
    time_track: float = 0.0
    time_pt_extract: float = 0.0
    time_ln_detect: float = 0.0
    time_ln_descri: float = 0.0
    time_pt_stereo: float = 0.0
    time_ln_stereo: float = 0.0
    time_pt_cross: float = 0.0
    time_ln_cross: float = 0.0
    time_ln_cut: float = 0.0
    time_pose_optim: float = 0.0
    num_pt_stereo: int = 0
    num_ln_stereo: int = 0
    num_pt_cross: int = 0
    num_ln_cross: int = 0

    def row(self) -> str:
        return " ".join(f"{getattr(self, f):.6f}" if f.startswith("time")
                        else str(getattr(self, f)) for f in FIELDS)


@dataclass
class TimeLogWriter:
    """Collects TimeLog rows and writes the ``<out>_Log.txt`` format."""
    rows: List[TimeLog] = field(default_factory=list)

    def append(self, log: TimeLog) -> None:
        self.rows.append(log)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("# " + " ".join(FIELDS) + "\n")
            for r in self.rows:
                f.write(r.row() + "\n")
