"""Median over the traced sequence's keyframe frames of the host ms spent
in blocking device-to-host reads (the ``wait.*`` spans) inside the frame's
``slam.process``."""

from slam_bench.program_trace import keyframe_wait_ms


def read(run):
    return keyframe_wait_ms()
