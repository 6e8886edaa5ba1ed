"""Median host ms of one SLAM session (the ``batch.sequence`` span: a fresh
engine, ``run_sequence`` and ``finish()``) over every rank's sessions of
the traced round, each rank under its own profiler."""

from slam_bench.program_trace import median_ms


def read(run):
    return median_ms("batch.sequence")
