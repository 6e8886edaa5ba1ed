"""Median host ms of one local-BA LM iteration (the ``ba.iter`` span) in the
traced sequence: its dispatch, with the profiler's host overhead."""

from slam_bench.program_trace import median_ms


def read(run):
    return median_ms("ba.iter")
