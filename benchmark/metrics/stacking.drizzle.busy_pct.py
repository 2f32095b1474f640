"""stacking.drizzle.busy_pct: the share of the exact drizzle's time in
which the card was busy: device-busy time inside the port's own
``stacking.drizzle`` spans (the body of ``_drizzle_kernel_exact``: 128
bands of taps, gather and K7) over the spans' length. The rest is the
card waiting for the host to launch the bands."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.busy_pct(run, "stacking.drizzle")
