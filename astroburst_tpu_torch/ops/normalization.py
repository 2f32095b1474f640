"""Normalization primitives (counterpart of
astroburst_tpu/ops/normalization.py; reference:
src-tauri/src/math/normalization.rs).

Plain f32 reductions on the tensor's device. The sums are torch's
(pairwise on the CPU, tree reductions on the card), not XLA's, so a
mean or a sigma can differ from JAX's by a few ulp.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime.device import as_f32_all


def min_max_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x − min)/(max − min); constant arrays → 0 (normalization.rs:18)."""
    mn = x.min()
    rng = x.max() - mn
    out = (x - mn) / torch.clamp(rng, min=1e-30)
    return torch.where(rng > 1e-30, out, torch.zeros_like(x))


def z_score_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x − mean)/std over finite values (normalization.rs:56)."""
    finite = torch.isfinite(x)
    cnt = torch.clamp(finite.sum(dtype=torch.float32), min=1.0)
    mean = torch.where(finite, x, 0.0).sum() / cnt
    var = torch.where(finite, (x - mean) ** 2, 0.0).sum() / cnt
    std = torch.sqrt(var)
    out = (x - mean) / torch.clamp(std, min=1e-30)
    return torch.where(std > 1e-30, out, torch.zeros_like(x))


def unit_energy_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ‖x‖₂ (normalization.rs:102)."""
    norm = torch.sqrt((x * x).sum())
    out = x / torch.clamp(norm, min=1e-30)
    return torch.where(norm > 1e-30, out, x)


def compute_mean_sigma(x: torch.Tensor):
    """(mean, sample std) over finite values as 0-d tensors; (0, 0) when
    none is finite (normalization.rs:128-163)."""
    finite = torch.isfinite(x)
    cnt = finite.sum(dtype=torch.float32)
    mean = torch.where(finite, x, 0.0).sum() / torch.clamp(cnt, min=1.0)
    var = torch.where(finite, (x - mean) ** 2, 0.0).sum() / torch.clamp(
        cnt - 1.0, min=1.0)
    sigma = torch.sqrt(var)
    empty = cnt < 1.0
    return torch.where(empty, 0.0, mean), torch.where(empty, 0.0, sigma)


def compute_snr(peak, mean, sigma, *, device=None):
    """(peak − mean)/σ with σ ≈ 0 → 0 (normalization.rs:165-170). The
    three are placed on ``device``, else on a tensor argument's device,
    else on the card (raising where there is none)."""
    peak, mean, sigma = as_f32_all(peak, mean, sigma, device=device)
    a = torch.abs(sigma)
    return torch.where(a < 1e-30, 0.0,
                       (peak - mean) / torch.clamp(a, min=1e-30))
