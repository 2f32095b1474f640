"""alignment.phase_corr.graph_pct: the share of the phase correlation's
calls inside the window that replayed their CUDA graphs: the port's
counter ``alignment.phase_corr.graph_replay`` over it plus
``alignment.phase_corr.eager`` (a call on the card that ran its ops one
at a time), in %. A port without the counters reads nothing."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    replay = program_spans.count(run, "alignment.phase_corr.graph_replay")
    eager = program_spans.count(run, "alignment.phase_corr.eager")
    if replay is None and eager is None:
        return None
    replay, eager = replay or 0, eager or 0
    return 100.0 * replay / (replay + eager)
