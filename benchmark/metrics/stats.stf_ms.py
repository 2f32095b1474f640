"""stats.stf_ms: milliseconds a request spends in the statistics and the
STF: the port's own ``stats.core`` (min, max, the two sorts for the
median and the MAD) and ``stats.stf`` (auto-STF and the u8 stretch)
spans, their union over the requests of the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["stats.core", "stats.stf"])
