"""cube.median.roofline_pct: the median collapse's share of its bytes
roofline. The operation reads the cube once and writes the median plane
once: 4 * (D * H * W + H * W) bytes (2.148 GB for 2048 x 512^2), over
the card's published HBM rate, divided by the device-busy time inside
the spans around the call as ``api.cube`` binds it."""

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.api.cube:collapse_median"]


def op_bytes(data: dict, params: dict) -> int:
    return 4 * (data["depth"] + 1) * data["height"] * data["width"]


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
