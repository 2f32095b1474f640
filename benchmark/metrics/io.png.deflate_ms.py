"""io.png.deflate_ms: milliseconds a command spends in zlib for its
preview PNG: the port's own ``io.png.deflate`` spans (one
``zlib.compress`` of the scanlines), over the commands of the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["io.png.deflate"])
