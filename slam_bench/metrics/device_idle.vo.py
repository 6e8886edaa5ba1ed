"""Share of the traced sequence's span in which no device activity ran,
in % (the VO cell)."""

from slam_bench.trace import idle_pct as read  # noqa: F401
