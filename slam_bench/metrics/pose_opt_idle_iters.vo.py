"""Share, in %, of the pose solver's dispatched Gauss-Newton iterations that
began converged in the traced sequence (counters ``pose_opt.iters_*``): host
dispatch that does nothing on the card."""

from slam_bench.program_trace import idle_iters_pct


def read(run):
    return idle_iters_pct("pose_opt")
