"""Median host ms of the tracker's ``vo.track`` span over the traced
sequence's tracked frames (``track_step``: its dispatch, with the
profiler's host overhead)."""

from slam_bench.program_trace import median_ms


def read(run):
    return median_ms("vo.track")
