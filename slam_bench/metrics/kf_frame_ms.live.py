"""Median latency, in ms, of the window's keyframe frames (the frames
whose record says ``is_kf``), from the harness's per-frame clock, over the
sequences that ran without the profiler."""

import statistics


def read(run):
    ms = [1e3 * x for s in run.seqs if s.latency_s and not s.traced
          for x, kf in zip(s.latency_s, s.is_kf) if kf]
    return statistics.median(ms) if ms else None
