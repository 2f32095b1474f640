"""cube.stats.roofline_pct: the cube's global statistics' share of their
bytes roofline. The operation reads the cube twice, once for the values
(median, 1% and 99.9% ranks) and once for the deviations from the
median (the MAD): 2 * 4 * D * H * W bytes (4.295 GB for 2048 x 512^2),
over the card's published HBM rate, divided by the device-busy time
inside the spans around the call as ``api.cube`` binds it."""

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.api.cube:compute_global_stats"]


def op_bytes(data: dict, params: dict) -> int:
    return 2 * 4 * data["depth"] * data["height"] * data["width"]


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
