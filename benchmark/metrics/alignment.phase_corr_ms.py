"""alignment.phase_corr_ms: milliseconds a request spends in the phase
correlation (K1, K2 and cuFFT), from a span around the call."""

from benchmark.core.layers import span_ms_per_request

SPANS = ["astroburst_tpu_torch.parallel.pipeline:phase_correlate_stack"]


def read(run):
    return span_ms_per_request(run, SPANS)
