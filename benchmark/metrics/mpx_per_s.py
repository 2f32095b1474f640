"""mpx_per_s: input megapixels of all requests completed in the window
over the window's length (host clock; the window ends when its last
request has returned)."""

from benchmark.core.stats import rate


def read(run):
    return rate(run.mpx, run.window_s)
