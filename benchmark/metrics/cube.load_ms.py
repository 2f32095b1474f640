"""cube.load_ms: milliseconds a command spends loading its cube: the
port's own ``cube.load`` spans (``io.prefetch.load_cube``: the host
decode of the whole file through two pinned staging buffers and the
copies to the card on a side stream), over the commands of the
window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["cube.load"])
