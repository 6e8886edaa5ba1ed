"""Share of the traced sequence's span in which no device activity ran,
in % (the SLAM cells)."""

from slam_bench.trace import idle_pct as read  # noqa: F401
