"""N-channel × 3 weight-matrix blending (counterpart of
astroburst_tpu/compose/channel_blend.py; reference:
src-tauri/src/core/compose/channel_blend.rs).

Out_c = Σ_k W[k, c] · Channel_k. The JAX package computes it as one
einsum at HIGHEST precision, outside any Pallas kernel; here it is a
weighted sum over the channels in index order, each product and sum
its own f32 operation (no library reduction picks another order), on
the planes' device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.runtime.device import as_f32_all


def blend_weights(n: int, weights: Sequence[dict]) -> np.ndarray:
    """The [n, 3] f32 matrix of ``weights`` entries
    ``{channel_idx, r_weight, g_weight, b_weight}``: indices at or past
    ``n`` are ignored, and repeated indices add up
    (channel_blend.rs:13-70)."""
    w = np.zeros((n, 3), np.float32)
    for entry in weights:
        idx = int(entry["channel_idx"])
        if idx < n:
            w[idx, 0] += float(entry["r_weight"])
            w[idx, 1] += float(entry["g_weight"])
            w[idx, 2] += float(entry["b_weight"])
    return w


def blend_channels(channels: Sequence, weights: Sequence[dict]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, G, B) planes of the blend of ``channels`` (each [H, W], on
    the first one's device)."""
    planes = as_f32_all(*channels)
    w = torch.from_numpy(blend_weights(len(planes), weights)).to(
        planes[0].device)
    out = []
    for c in range(3):
        acc = planes[0] * w[0, c]
        for k in range(1, len(planes)):
            acc = acc + planes[k] * w[k, c]
        out.append(acc)
    return out[0], out[1], out[2]
