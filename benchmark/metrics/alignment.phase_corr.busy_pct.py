"""alignment.phase_corr.busy_pct: the share of the phase correlation's
time in which the card was busy: device-busy time inside the port's own
``alignment.phase_corr`` spans (the body of ``phase_correlate_stack``:
K1, cuFFT, the peaks, K2; no synchronize inside) over the spans'
length. The rest is the card waiting for the host's launches."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.busy_pct(run, "alignment.phase_corr")
