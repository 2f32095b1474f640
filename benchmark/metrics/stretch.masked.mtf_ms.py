"""stretch.masked.mtf_ms: milliseconds a command spends in the MTF loops
under the mask: the port's own ``stretch.masked.mtf`` spans (each
channel's normalisation, its iterations' masked medians and blends, the
final median, and the stop flags' fetches that wait for them), over the
commands of the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["stretch.masked.mtf"])
