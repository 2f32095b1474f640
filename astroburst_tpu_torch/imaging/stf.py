"""Screen Transfer Function and auto-stretch
(counterpart of astroburst_tpu/imaging/stf.py; reference:
src-tauri/src/core/imaging/stf.rs).

Two forms, as in the JAX package:

- host appliers (``auto_stf``, ``apply_stf_f32``, ``apply_stf_u8``):
  the parameters are derived on the host in f64 from an ImageStats,
  then handed to the elementwise pass as f32 scalars (one small copy
  to the plane's device);
- traced forms (``auto_stf_traced``, ``apply_stf_traced``): the
  parameters stay 0-d tensors on the plane's device, so a fused
  pipeline never waits on the host.

Semantics kept verbatim: x ≤ 0 → 0, x ≥ 1 → 1; invalid and padding
pixels render black; shadow clamp [0, 0.98]; midtone clamp
[1e-4, 0.9999] via mtf_balance; |denom| guard. Plain elementwise
torch: the JAX package computes these outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.dtypes import AutoStfConfig, ImageStats, StfParams
from astroburst_tpu_torch.ops.masking import validity_mask


def mtf(x: float, m: float) -> float:
    """Midtone transfer function, scalar host version (stf.rs:50-58)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    return (m - 1.0) * x / ((2.0 * m - 1.0) * x - m)


def mtf_balance(m: float, t: float) -> float:
    """Inverse MTF: the midtone that maps m to target t (stf.rs:41-47)."""
    denom = 2.0 * t * m - t - m
    if abs(denom) < 1e-15:
        return 0.5
    return min(max(m * (t - 1.0) / denom, 0.0001), 0.9999)


def auto_stf(stats: ImageStats,
             config: AutoStfConfig = AutoStfConfig()) -> StfParams:
    """Auto-stretch parameters from robust stats (stf.rs:13-39)."""
    if stats.valid_count == 0:
        return StfParams()
    rng = max(stats.max - stats.min, 1e-30)
    median_norm = (stats.median - stats.min) / rng
    sigma_norm = stats.sigma / rng
    shadow = min(max(median_norm + config.shadow_k * sigma_norm, 0.0), 0.98)
    highlight = 1.0
    clip_range = max(highlight - shadow, 1e-15)
    m_clipped = min(max((median_norm - shadow) / clip_range, 0.0), 1.0)
    if m_clipped <= 0.0 or m_clipped >= 1.0:
        midtone = 0.5
    else:
        midtone = mtf_balance(m_clipped, config.target_bg)
    return StfParams(shadow=shadow, midtone=midtone, highlight=highlight)


def _stf_core(x, dmin, inv_range, shadow, inv_clip, midtone):
    """Vector MTF with the reference's boundary semantics (stf.rs:81-87)."""
    norm = (x - dmin) * inv_range
    c = torch.clamp((norm - shadow) * inv_clip, 0.0, 1.0)
    m = midtone
    denom = (2.0 * m - 1.0) * c - m
    stretched = (m - 1.0) * c / denom
    return torch.where(c <= 0.0, torch.zeros_like(c),
                       torch.where(c >= 1.0, torch.ones_like(c), stretched))


def _finish(out, x, as_u8: bool):
    """Invalid pixels → 0; u8 with round-half-even ×255, else f32."""
    valid = validity_mask(x)
    if as_u8:
        q = torch.clamp(torch.round(out * 255.0), 0.0, 255.0)
        return torch.where(valid, q, torch.zeros_like(q)).to(torch.uint8)
    return torch.where(valid, out, torch.zeros_like(out)).to(torch.float32)


def _params_scalars(params: StfParams, stats: ImageStats, device):
    """(dmin, 1/range, shadow, 1/clip range, midtone): f64 host math,
    each rounded to f32, in one copy to ``device``; 0-d views."""
    rng = max(stats.max - stats.min, 1e-30)
    clip_range = max(params.highlight - params.shadow, 1e-15)
    vals = torch.tensor([stats.min, 1.0 / rng, params.shadow,
                         1.0 / clip_range, params.midtone],
                        dtype=torch.float32).to(device)
    return tuple(vals.unbind())


def apply_stf_f32(x: torch.Tensor, params: StfParams,
                  stats: ImageStats) -> torch.Tensor:
    """STF'd f32 plane; invalid pixels → 0 (stf.rs:104-120)."""
    out = _stf_core(x, *_params_scalars(params, stats, x.device))
    return _finish(out, x, as_u8=False)


def apply_stf_u8(x: torch.Tensor, params: StfParams,
                 stats: ImageStats) -> torch.Tensor:
    """STF'd u8 plane for rendering; invalid → black (stf.rs:89-102)."""
    out = _stf_core(x, *_params_scalars(params, stats, x.device))
    return _finish(out, x, as_u8=True)


# --- traced variants for fused device pipelines -----------------------------


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
    return _finish(out, x, as_u8)
