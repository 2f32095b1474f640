"""LRGB combination and luminance synthesis (counterpart of
astroburst_tpu/compose/lrgb.py; reference:
src-tauri/src/core/compose/lrgb.rs).

Plain elementwise torch on the planes' device, every operation rounded
to f32 (XLA on the CPU contracts the multiply-adds to FMA; ROADMAP C13,
C19). Dark pixels (old luminance < 1e-10) take l · lightness_weight
unclipped; the others are clipped to [0, 1], as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime.device import as_f32_all


def synthesize_luminance(r, g, b) -> torch.Tensor:
    """BT.709 luminance (lrgb.rs:48-64)."""
    r, g, b = as_f32_all(r, g, b)
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def apply_lrgb(l, r, g, b, lightness_weight: float = 1.0,
               chrominance_weight: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Luminance replacement with chrominance blending (lrgb.rs:4-45)."""
    l, r, g, b = as_f32_all(l, r, g, b)
    if not (l.shape == r.shape == g.shape == b.shape):
        raise InvalidInput(
            f"L dims {tuple(l.shape)} do not match RGB {tuple(r.shape)}/"
            f"{tuple(g.shape)}/{tuple(b.shape)}")
    lw, cw = torch.tensor([lightness_weight, chrominance_weight],
                          dtype=torch.float32).to(l.device).unbind()
    lum_old = r * 0.2126 + g * 0.7152 + b * 0.0722
    dark = lum_old < 1e-10
    blended = l * lw
    ratio = (l * lw + lum_old * (1.0 - lw)) / \
        torch.where(dark, torch.ones_like(lum_old), lum_old)
    l_part = l * (1.0 - cw)

    def mix(ch):
        v = torch.clamp(ch * ratio * cw + l_part, 0.0, 1.0)
        return torch.where(dark, blended, v)

    return mix(r), mix(g), mix(b)
