"""Median host ms of the mapping step (the ``mapping.step`` span) over the
traced sequence's keyframe frames on the per-frame path, inside their
``slam.process``."""

from slam_bench.program_trace import median_ms


def read(run):
    return median_ms("mapping.step", inside="slam.process")
