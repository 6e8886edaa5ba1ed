"""Tracked frames (each sequence's frames but its bootstrap frame) over
the whole window's seconds, on the host clock."""

from slam_bench.window import rate


def read(run):
    return rate(sum(s.tracked for s in run.seqs), run.seconds)
