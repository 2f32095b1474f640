"""command_mpx_per_s: input megapixels of all commands completed in the
window (files in to files out) over the window's length (host clock)."""

from benchmark.core.stats import rate


def read(run):
    return rate(run.mpx, run.window_s)
