"""alignment.affine.detect.roofline_pct: the star detection's share of
its bytes roofline. Each detection reads the plane it detects on once
(4 * rows * cols bytes on the SW grid; three a command, R harmonized,
G and B: 149.70 MB at 5655 x 2206), over the card's published HBM
rate, divided by the device-busy time inside the spans around the
fused chain's ``_detect_device`` (normalize, K10 and K11, the dedupe)."""

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.alignment.fused_chain:_detect_device"]


def op_bytes(data: dict, params: dict) -> int:
    return 4 * data["sw_height"] * data["sw_width"]


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
