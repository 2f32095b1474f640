"""SCNR green-noise removal (counterpart of astroburst_tpu/imaging/scnr.py).

Reference: src-tauri/src/core/imaging/scnr.rs — average/maximum-neutral
green limit, amount lerp, and BT.709 luminance redistribution to R/B
(Δ = 0.7152·δG / (0.2126 + 0.0722)) skipping pixels already > 1.0.
Plain elementwise torch on the planes' device, every operation rounded
to f32 (torch contracts nothing: bit-equal to the reference's scalar
f32 oracle, where XLA on the CPU contracts the lerp to an FMA,
ROADMAP C13).
"""

from __future__ import annotations

from typing import Tuple

import torch

from astroburst_tpu_torch.dtypes import ScnrConfig, ScnrMethod

LUM_R = 0.2126
LUM_G = 0.7152
LUM_B = 0.0722
INV_RB_WEIGHT = 1.0 / (LUM_R + LUM_B)


def scnr_core(r, g, b, amount, maximum_neutral: bool,
              preserve_luminance: bool):
    limit = torch.maximum(r, b) if maximum_neutral else (r + b) * 0.5
    g_corrected = torch.minimum(g, limit)
    g_new = g + amount * (g_corrected - g)
    delta_g = g - g_new
    if preserve_luminance:
        boost = LUM_G * delta_g * INV_RB_WEIGHT
        apply = (delta_g > 1e-10) & (r <= 1.0) & (b <= 1.0)
        r = torch.where(apply, torch.clamp(r + boost, max=1.0), r)
        b = torch.where(apply, torch.clamp(b + boost, max=1.0), b)
    return r, g_new, b


def apply_scnr(r, g, b, config: ScnrConfig = ScnrConfig()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SCNR over three channel planes (scnr.rs:18-52); returns new
    planes, or the inputs themselves when their shapes differ or the
    clamped amount is below 1e-7."""
    if r.shape != g.shape or g.shape != b.shape:
        return r, g, b
    amount = min(max(config.amount, 0.0), 1.0)
    if amount < 1e-7:
        return r, g, b
    amt = torch.tensor(amount, dtype=torch.float32).to(g.device)
    return scnr_core(r, g, b, amt,
                     config.method == ScnrMethod.MAXIMUM_NEUTRAL,
                     config.preserve_luminance)
