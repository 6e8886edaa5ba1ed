"""The 90th percentile, over every frame of the window, of the time from
handing the frame to the engine to its return with the pose on the host."""

from slam_bench.window import percentile, window_latencies_ms


def read(run):
    ms = window_latencies_ms(run.seqs)
    return percentile(ms, 90) if ms else None
