"""Robust asinh preview normalization (counterpart of
astroburst_tpu/imaging/normalize.py).

Reference: src-tauri/src/math/simd.rs:160-215 (asinh_normalize_simd,
re-exported as core/imaging/normalize.rs robust_asinh_preview): robust
median/MAD + 1%/99.9% percentile clamp, then asinh(α·(v−median)/σ)
with α = 10; invalid (non-finite or ≤ 1e-7) → 0.

The JAX package finds the three ranks and the MAD by its compare-count
quantile (within range/8⁶ of the exact value, ROADMAP C5); the port
selects them exactly, by one sort of the valid values and one of their
deviations, as the reference's select_nth does.
"""

from __future__ import annotations

import numpy as np
import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA, PADDING_THRESHOLD


def robust_asinh_preview(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    valid = torch.isfinite(flat) & (flat > PADDING_THRESHOLD)
    vals = torch.sort(flat[valid]).values
    cnt = vals.numel()
    if cnt == 0:
        return x
    # the ranks in f32, as the reference and the JAX package take them
    n = np.float32(cnt)
    mid = int(np.floor(n / np.float32(2.0)))
    lo = int(np.floor(n * np.float32(0.01)))
    hi = int(min(np.floor(n * np.float32(0.999)), n - np.float32(1.0)))
    median = vals[mid]
    mad = torch.sort(torch.abs(vals - median)).values[mid]
    sigma = torch.clamp(mad * MAD_TO_SIGMA, min=1e-10)
    alpha = 10.0
    clamped = torch.clamp(x, vals[lo], vals[hi])
    out = torch.asinh((alpha / sigma) * (clamped - median))
    keep = torch.isfinite(x) & (x > PADDING_THRESHOLD)
    return torch.where(keep, out, 0.0).to(torch.float32)
