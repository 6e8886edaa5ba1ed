"""Median host ms of the front-end's ``vo.frontend`` span over the traced
sequence's frames (``process_stereo_pair``: its dispatch, with the
profiler's host overhead)."""

from slam_bench.program_trace import median_ms


def read(run):
    return median_ms("vo.frontend")
