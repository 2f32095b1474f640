"""compose.color_ms: milliseconds a command spends on its colour: the
port's own ``compose.color`` spans (the six image statistics, the
white balance, the STF of each channel and SCNR), over the commands of
the window."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    return program_spans.ms_per_request(run, ["compose.color"])
