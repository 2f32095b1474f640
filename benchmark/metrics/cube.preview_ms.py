"""cube.preview_ms: milliseconds a command spends on its previews: the
port's own ``cube.previews`` spans (the asinh normalize and u8 of the
two collapses and the sampled frames on the card, their fetches, and
the PNG encodes on a pool of 4 threads), over the commands of the
window. The span does not synchronize: device work queued before it
(the median collapse, where nothing synchronized after it) is waited
for by its first fetch."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["cube.previews"])
