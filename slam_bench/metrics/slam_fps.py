"""Frames through full SLAM over the whole window's seconds, each
sequence's ``finish()`` included, on the host clock."""

from slam_bench.window import rate


def read(run):
    return rate(sum(s.frames for s in run.seqs), run.seconds)
