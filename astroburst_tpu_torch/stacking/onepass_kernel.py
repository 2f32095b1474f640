"""K3: fused Catmull-Rom shift + per-pixel sigma clip.

One CUDA kernel (``csrc/shift_clip.cu``; header note there: what bounds
it and how it is laid out) replaces BOTH TPU kernels of the stacking
path:

- astroburst_tpu/stacking/onepass_kernel.py:_shift_clip_onepass_padded
  (entries ``shift_clip_onepass``/``_slab``; N ≤ 20, offsets ±16);
- astroburst_tpu/stacking/fused_kernel.py:shift_clip_fused
  (with ``_preshift_integer``; any N, offsets [-254, 253]).

It takes any N up to ``MAX_FRAMES`` and any offset: there is no clamp,
as in ``shift_bicubic`` and AstroBurst. Its plain version is
ops/resample.py:shift_bicubic_batch followed by
stacking/clip.py:sigma_clip_core, which is what the JAX pipeline runs
off the TPU.

``shift_clip_onepass`` launches the kernel for a CUDA tensor and runs
``shift_clip_onepass_plain`` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.resample import as_offsets, shift_bicubic_batch
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking.clip import sigma_clip_core

MAX_FRAMES = 128  # the kernel's largest template bound (csrc/shift_clip.cu)


def shift_clip_onepass_plain(stack: torch.Tensor, dys, dxs,
                             sigma_low: float = 3.0, sigma_high: float = 3.0,
                             max_iter: int = 5):
    """shift_bicubic_batch + sigma_clip_core, in torch."""
    return sigma_clip_core(shift_bicubic_batch(stack, dys, dxs), sigma_low,
                           sigma_high, max_iter)


def shift_clip_onepass(stack: torch.Tensor, dys, dxs,
                       sigma_low: float = 3.0, sigma_high: float = 3.0,
                       max_iter: int = 5):
    """Shift frame k of [N, H, W] by (dys[k], dxs[k]) bicubically, then
    sigma-clip combine over the frames. Returns (combined [H, W] f32,
    rejected: 0-d int64 tensor)."""
    if not K.use_kernel(stack, "shift_clip_onepass"):
        return shift_clip_onepass_plain(stack, dys, dxs, sigma_low,
                                        sigma_high, max_iter)
    K.require_cuda(stack, "stack", 3)
    n, h, w = stack.shape
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"shift_clip_onepass takes 1..{MAX_FRAMES} "
                         f"frames, got {n}")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    dy = as_offsets(dys, n, stack.device)
    dx = as_offsets(dxs, n, stack.device)
    # sub-1e-12 offsets snap to exact zero, so the kernel's raw-pixel
    # path fires exactly where shift_bicubic returns the frame untouched
    # (onepass_kernel.py:282-285)
    zero = torch.zeros((), dtype=torch.float32, device=stack.device)
    dy = torch.where(torch.abs(dy) < 1e-12, zero, dy).contiguous()
    dx = torch.where(torch.abs(dx) < 1e-12, zero, dx).contiguous()
    out = torch.empty((h, w), dtype=torch.float32, device=stack.device)
    rejected = torch.empty((h, w), dtype=torch.int32, device=stack.device)
    K.launch("abt_shift_clip", stack.data_ptr(), dy.data_ptr(),
             dx.data_ptr(), n, h, w, float(sigma_low), float(sigma_high),
             int(max_iter), out.data_ptr(), rejected.data_ptr(),
             K.stream_handle(stack))
    shift_clip_onepass.launches += 1
    return out, rejected.sum()


shift_clip_onepass.launches = 0
