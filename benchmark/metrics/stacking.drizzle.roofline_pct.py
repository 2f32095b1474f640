"""stacking.drizzle.roofline_pct: the exact drizzle's share of its bytes
roofline. The operation reads each frame once and writes the image and
the weight map once: (N * H * W + 2 * ceil(H s) * ceil(W s)) * 4 bytes
(1.208 GB for 10 x 4096^2 at scale 2), over the card's published HBM
rate, divided by the device-busy time inside the spans around the
drizzle step."""

import math

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.stacking.drizzle:_drizzle_kernel_exact"]


def op_bytes(data: dict, params: dict) -> int:
    s = min(max(params["scale"], 1.0), 4.0)
    h, w = data["height"], data["width"]
    return (data["frames"] * h * w
            + 2 * math.ceil(h * s) * math.ceil(w * s)) * 4


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
