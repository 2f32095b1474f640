"""stretch.masked.mask_ms: milliseconds a command spends building its
star mask: the port's own ``stretch.masked.mask`` spans (the luminance,
detection with K10 and K11, the 3 px dedupe, the paint with K13, the
luminance protection and the one fetch of the counts that waits for
them), over the commands of the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["stretch.masked.mask"])
