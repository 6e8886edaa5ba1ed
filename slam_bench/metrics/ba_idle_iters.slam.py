"""Share, in %, of the bundle adjustments' dispatched LM iterations that
began converged in the traced sequence (counters ``ba.iters_*``): host
dispatch that does nothing on the card."""

from slam_bench.program_trace import idle_iters_pct


def read(run):
    return idle_iters_pct("ba")
