"""Align + stack + stretch on one device
(counterpart of astroburst_tpu/parallel/pipeline.py:align_stack_stretch).

N raw frames [N, H, W] → phase-correlation alignment to frame 0
(kernels K1 + K2 and cuFFT) → fused bicubic shift + per-pixel sigma
clip (kernel K3) → robust stats → auto-STF → u8 stretch. Every step
stays on the device; nothing waits on the host. The TPU switches of
the JAX function (``use_pallas``, ``true_shape``, ``off_max``,
``interpret``) have no counterpart: the stack is unpadded and the
shift is not clamped.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.alignment.phase_correlation import (
    phase_correlate_stack)
from astroburst_tpu_torch.imaging.stf import apply_stf_traced, auto_stf_traced
from astroburst_tpu_torch.ops.stats import stats_core
from astroburst_tpu_torch.stacking.onepass_kernel import (
    shift_clip_onepass, shift_clip_onepass_plain)


def align_stack_stretch(stack: torch.Tensor, sigma_low: float = 3.0,
                        sigma_high: float = 3.0, max_iter: int = 5,
                        align: bool = True, exact_pair: bool = False, *,
                        plain: bool = False) -> dict:
    """Run the pipeline over a contiguous f32 [N, H, W] stack.

    Returns a dict of tensors on the stack's device: combined f32
    [H, W], preview u8 [H, W], offsets [N, 2] f32 (frame 0 is the
    reference, offset 0), confidences [N] f32, rejected (0-d int64),
    stf (shadow, midtone) f32 [2], data_range (min, max) f32 [2].
    ``plain`` runs the plain torch versions of the kernels instead (to
    hold the kernels to them on the card).
    """
    n = stack.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=stack.device)
    if align and n > 1:
        dys1, dxs1, confs1 = phase_correlate_stack(stack[0], stack[1:],
                                                   plain=plain)
        dys = torch.cat([zeros[:1], dys1])
        dxs = torch.cat([zeros[:1], dxs1])
        confs = torch.cat([zeros[:1], confs1])
    else:
        dys = dxs = confs = zeros

    clip = shift_clip_onepass_plain if plain else shift_clip_onepass
    combined, rejected = clip(stack, dys, dxs, sigma_low, sigma_high,
                              max_iter)
    mn, mx, _total, count, med, mad = stats_core(combined, exact_pair)
    sigma = torch.clamp(mad * 1.4826, min=1e-30)
    shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
    preview = apply_stf_traced(combined, mn, mx, shadow, midtone, as_u8=True)
    return {
        "combined": combined,
        "preview": preview,
        "offsets": torch.stack([dys, dxs], dim=1),
        "confidences": confs,
        "rejected": rejected,
        "stf": torch.stack([shadow, midtone]),
        "data_range": torch.stack([mn, mx]),
    }
