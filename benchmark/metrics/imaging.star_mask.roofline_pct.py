"""imaging.star_mask.roofline_pct: the star mask's raster share of its
bytes roofline. The raster (K13, then the luminance protection) writes
the mask plane once and reads the luminance once: 8 * rows * cols bytes
(1.37 GB at 13759 x 12451), over the card's published HBM rate, divided
by the device-busy time inside the spans around ``_mask_kernel`` as
``imaging.star_mask`` holds it. The star records (12 B each) are left
out: they are read from the cache."""

from benchmark.core.layers import roofline_pct

SPANS = ["astroburst_tpu_torch.imaging.star_mask:_mask_kernel"]


def op_bytes(data: dict, params: dict) -> int:
    return 8 * data["sw_height"] * data["sw_width"]


def read(run):
    return roofline_pct(run, SPANS, op_bytes)
