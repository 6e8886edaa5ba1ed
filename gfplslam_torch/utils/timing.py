"""Per-frame, per-module timing log (TimeLog parity, stereoFrame.h:66-86).

The reference records wall time + feature counts per pipeline stage and dumps
one row per frame to ``<out>_Log.txt`` (plslam_mod.cpp:494-513). Metric names
are kept identical so BASELINE comparisons hold. On TPU most stages fuse into
one or two device programs; stages that share a program report the program's
share under the fused name and the driver records the fused total too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

FIELDS = [
    "time_track", "time_pt_extract", "time_ln_detect", "time_ln_descri",
    "time_pt_stereo", "time_ln_stereo", "time_pt_cross", "time_ln_cross",
    "time_ln_cut", "time_pose_optim",
    "num_pt_stereo", "num_ln_stereo", "num_pt_cross", "num_ln_cross",
]


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


class StageTimer:
    """Host-side wall timer for device-program stages."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
