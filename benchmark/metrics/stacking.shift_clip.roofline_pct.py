"""stacking.shift_clip.roofline_pct: the shift + clip's share of its
bytes roofline. The operation reads each frame once and writes the
combined plane once: (N + 1) * H * W * 4 bytes (848.3 MB for 16 x
5655 x 2206), over the card's published HBM rate, divided by the
device-busy time inside the spans around the call."""

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.parallel.pipeline:shift_clip_onepass"]


def op_bytes(data: dict, params: dict) -> int:
    return (data["frames"] + 1) * data["height"] * data["width"] * 4


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
