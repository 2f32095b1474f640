"""Published peaks of the card, by the name ``torch.cuda`` gives it.

NVIDIA's data sheet for the H100 SXM5 80 GB (dense rates): 3.35 TB/s of
HBM3 and 67 TFLOP/s of FP32 outside the tensor cores, at the full
700 W power limit. A card set below 700 W runs slower under load; the
run prints the card's power limit beside every roofline.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}

