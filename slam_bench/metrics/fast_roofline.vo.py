"""The FAST kernel's share of its bytes roofline in the traced sequence,
in %: the least bytes of every launch (its shapes) at the HBM rate, over
the kernel's device time in the trace."""

from slam_bench import roofline


def read(run):
    if run.trace is None:
        return None
    secs, n = run.trace.kernel_s("fast_score_kernel")
    shapes = [s for kind, s in run.kernel_shapes if kind == "fast"]
    if n == 0 or n != len(shapes):
        return None
    return roofline.share_pct(sum(roofline.fast_bytes(s) for s in shapes), secs, run.kind)
