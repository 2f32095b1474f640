"""device.idle_pct.command: the share of the traced window in which no
kernel, copy or fill ran on the card (the union of their intervals
from the profiler's device trace)."""

from benchmark.core.layers import idle_pct


def read(run):
    return idle_pct(run)
