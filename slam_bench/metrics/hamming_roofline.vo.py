"""The Hamming kernel's share of its bytes roofline in the traced
sequence, in %: the least bytes of every launch (its problems' shapes and
masks) at the HBM rate, over the kernel's device time in the trace."""

from slam_bench import roofline


def read(run):
    if run.trace is None:
        return None
    secs, n = run.trace.kernel_s("hamming_kernel")
    launches = [p for kind, p in run.kernel_shapes if kind == "hamming"]
    if n == 0 or n != len(launches):
        return None
    return roofline.share_pct(sum(roofline.hamming_bytes(p) for p in launches), secs,
                              run.kind)
