"""Screen Transfer Function and auto-stretch on tensors
(counterpart of the traced functions of astroburst_tpu/imaging/stf.py).

Semantics kept verbatim (stf.rs): x ≤ 0 → 0, x ≥ 1 → 1; invalid and
padding pixels render black; shadow clamp [0, 0.98]; midtone clamp
[1e-4, 0.9999] via mtf_balance; |denom| guard. Parameters stay 0-d
tensors on the plane's device, so the stretch never waits on the host.
Plain elementwise torch: the JAX package computes these outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.masking import validity_mask


def _stf_core(x, dmin, inv_range, shadow, inv_clip, midtone):
    """Vector MTF with the reference's boundary semantics (stf.rs:81-87)."""
    norm = (x - dmin) * inv_range
    c = torch.clamp((norm - shadow) * inv_clip, 0.0, 1.0)
    m = midtone
    denom = (2.0 * m - 1.0) * c - m
    stretched = (m - 1.0) * c / denom
    return torch.where(c <= 0.0, torch.zeros_like(c),
                       torch.where(c >= 1.0, torch.ones_like(c), stretched))


def auto_stf_traced(dmin, dmax, median, sigma, valid_count,
                    target_bg: float = 0.25, shadow_k: float = -2.8):
    """Auto-STF parameters from robust stats; returns (shadow, midtone)
    as f32 0-d tensors (stf.rs:13-39)."""
    rng = torch.clamp(dmax - dmin, min=1e-30)
    median_norm = (median - dmin) / rng
    sigma_norm = sigma / rng
    shadow = torch.clamp(median_norm + shadow_k * sigma_norm, 0.0, 0.98)
    clip_range = torch.clamp(1.0 - shadow, min=1e-15)
    m = torch.clamp((median_norm - shadow) / clip_range, 0.0, 1.0)
    denom = 2.0 * target_bg * m - target_bg - m
    tiny = torch.abs(denom) < 1e-15
    balanced = torch.clamp(
        m * (target_bg - 1.0) / torch.where(tiny, torch.ones_like(denom),
                                            denom),
        0.0001, 0.9999)
    half = torch.full_like(m, 0.5)
    midtone = torch.where((m <= 0.0) | (m >= 1.0) | tiny, half, balanced)
    invalid = valid_count == 0
    return (torch.where(invalid, torch.zeros_like(shadow),
                        shadow).to(torch.float32),
            torch.where(invalid, half, midtone).to(torch.float32))


def apply_stf_traced(x, dmin, dmax, shadow, midtone, as_u8: bool = False):
    """Elementwise STF with tensor parameters (highlight = 1): f32 in
    [0, 1], or u8 with round-half-even ×255; invalid pixels → 0."""
    inv_range = 1.0 / torch.clamp(dmax - dmin, min=1e-30)
    inv_clip = 1.0 / torch.clamp(1.0 - shadow, min=1e-15)
    out = _stf_core(x, dmin, inv_range, shadow, inv_clip, midtone)
    valid = validity_mask(x)
    if as_u8:
        q = torch.clamp(torch.round(out * 255.0), 0.0, 255.0)
        return torch.where(valid, q, torch.zeros_like(q)).to(torch.uint8)
    return torch.where(valid, out, torch.zeros_like(out)).to(torch.float32)
