"""Validity masking (counterpart of astroburst_tpu/ops/masking.py).

The validity rule — finite and strictly above the padding threshold —
holds in every statistics and stretch path (stats.rs:10-13). The clip
and the phase-correlation gate use ``torch.isfinite`` alone, as the
JAX package does.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.constants import PADDING_THRESHOLD


def validity_mask(x: torch.Tensor) -> torch.Tensor:
    """finite && > 1e-7 (stats.rs:11)."""
    return torch.isfinite(x) & (x > PADDING_THRESHOLD)
