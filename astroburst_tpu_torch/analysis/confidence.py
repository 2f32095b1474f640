"""Detection / correlation-surface confidence helpers (counterpart of
astroburst_tpu/analysis/confidence.py).

Reference: src-tauri/src/core/analysis/confidence.rs:3-19 —
``compute_detection_snr`` (peak-above-background over background sigma,
0 when sigma ≲ ε) and ``compute_surface_confidence`` (peak z-score
against the surface's mean/sigma). f32 tensor math returning 0-d
tensors, so both compose into device pipelines. Inputs go to
``device``, else to a tensor argument's device, else to the card:
arrays and floats never stay on the CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.normalization import (compute_mean_sigma,
                                                    compute_snr)
from astroburst_tpu_torch.runtime.device import as_f32, as_f32_all

_EPS = torch.finfo(torch.float32).eps


def compute_detection_snr(peak_above_background, background_sigma, *,
                          device=None) -> torch.Tensor:
    """peak / sigma, 0 for degenerate sigma (confidence.rs:3-8)."""
    peak, sigma = as_f32_all(peak_above_background, background_sigma,
                             device=device)
    return torch.where(sigma <= _EPS, 0.0,
                       peak / torch.clamp(sigma, min=_EPS))


def compute_surface_confidence(surface, peak_value, *,
                               device=None) -> torch.Tensor:
    """z-score of the peak against the whole surface
    (confidence.rs:10-19); 0 for empty or flat surfaces."""
    surface = as_f32(surface, device).reshape(-1)
    if surface.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=surface.device)
    mean, sigma = compute_mean_sigma(surface)
    peak = as_f32(peak_value, surface.device)
    return torch.where(sigma <= _EPS, 0.0, compute_snr(peak, mean, sigma))
