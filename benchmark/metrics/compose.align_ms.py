"""compose.align_ms: milliseconds a command spends aligning G and B to
R: the port's own ``compose.align`` spans (``align_rgb_channels``: the
three detections, the triangles, the vote, the match, both RANSACs,
the two warps and the one info fetch that waits for them), over the
commands of the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["compose.align"])
