"""Arcsinh stretch (counterpart of astroburst_tpu/imaging/stretch.py;
reference: src-tauri/src/core/imaging/stretch.rs).

asinh(αx)/asinh(α) with optional gamma; the RGB variant shares a
global min/max across channels so color ratios survive
(stretch.rs:56-90). Plain elementwise torch on the plane's device:
the JAX package computes it outside any Pallas kernel. The scalars are
f32 0-d tensors, as the JAX kernel takes them; torch's ``asinh`` and
``pow`` can differ from XLA's by an ulp or two (ROADMAP C19).
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch.ops.stats import valid_range


def arcsinh_core(x, dmin, dmax, factor, gamma) -> torch.Tensor:
    """The arcsinh stretch of ``x`` with f32 0-d scalars; non-finite →
    0, a degenerate range → zeros (stretch.rs:22-44)."""
    rng = dmax - dmin
    inv_range = 1.0 / torch.clamp(rng, min=1e-30)
    inv_denom = 1.0 / torch.asinh(factor)
    norm = torch.clamp((x - dmin) * inv_range, 0.0, 1.0)
    stretched = torch.asinh(norm * factor) * inv_denom
    stretched = torch.where(torch.abs(gamma - 1.0) > 1e-6,
                            torch.pow(torch.clamp(stretched, min=0.0), gamma),
                            stretched)
    out = torch.where(torch.isfinite(x), stretched, 0.0)
    return torch.where(rng < 1e-10, torch.zeros_like(x),
                       out).to(torch.float32)


def arcsinh_stretch_with_stats(data: torch.Tensor, dmin: float, dmax: float,
                               factor: float,
                               gamma: float = 1.0) -> torch.Tensor:
    """The stretch over the given range; ``|factor| < 1e-10`` returns
    ``data`` itself."""
    if abs(factor) < 1e-10:
        return data
    s = torch.tensor([dmin, dmax, factor, gamma],
                     dtype=torch.float32).to(data.device)
    return arcsinh_core(data, *s.unbind())


def arcsinh_stretch(data: torch.Tensor, factor: float,
                    gamma: float = 1.0) -> torch.Tensor:
    dmin, dmax = valid_range(data)
    return arcsinh_stretch_with_stats(data, dmin, dmax, factor, gamma)


def arcsinh_stretch_rgb_with_stats(
        r, g, b, global_min: Optional[float], global_max: Optional[float],
        factor: float, gamma: float = 1.0):
    """Shared global min/max across channels (stretch.rs:56-90)."""
    if abs(factor) < 1e-10:
        return r, g, b
    if global_min is None or global_max is None:
        ranges = [valid_range(p) for p in (r, g, b)]
        global_min = min(lo for lo, _ in ranges)
        global_max = max(hi for _, hi in ranges)
    return tuple(arcsinh_stretch_with_stats(p, global_min, global_max,
                                            factor, gamma)
                 for p in (r, g, b))


def arcsinh_stretch_rgb(r, g, b, factor: float):
    return arcsinh_stretch_rgb_with_stats(r, g, b, None, None, factor, 1.0)
