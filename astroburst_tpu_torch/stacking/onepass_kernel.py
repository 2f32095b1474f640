"""K3: fused Catmull-Rom shift + per-pixel sigma clip.

One CUDA kernel (``csrc/shift_clip.cu``; header note there: what bounds
it and how it is laid out) replaces BOTH TPU kernels of the stacking
path:

- astroburst_tpu/stacking/onepass_kernel.py:_shift_clip_onepass_padded
  (entries ``shift_clip_onepass``/``_slab``; N ≤ 20, offsets ±16);
- astroburst_tpu/stacking/fused_kernel.py:shift_clip_fused
  (with ``_preshift_integer``; any N, offsets [-254, 253]).

It takes any N and any offset: there is no clamp, as in
``shift_bicubic`` and AstroBurst. Its plain version is
ops/resample.py:shift_bicubic_batch followed by
stacking/clip.py:sigma_clip_core, which is what the JAX pipeline runs
off the TPU.

``_clip_plan`` maps N (and the plane) to one of the kernel's three
instances: registers for N ≤ 32, shared memory for 33..128 frames, and
past that a global scratch [N, rows, W] launched over bands of rows so
that it stays within ``SCRATCH_MAX_BYTES``.

``shift_clip_onepass`` launches the kernel for a CUDA tensor and runs
``shift_clip_onepass_plain`` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from astroburst_tpu_torch.ops.resample import as_offsets, shift_bicubic_batch
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking.clip import sigma_clip_core

MAX_REG_FRAMES = 32        # register instances: CAP 4, 8, ..., 32
MAX_SHARED_FRAMES = 128    # shared-memory instance: 33..128 frames
MAX_SHARED_BYTES = 232448  # dynamic shared memory a block may hold
SCRATCH_MAX_BYTES = 1 << 30  # the scratch instance's band, at most


class ClipPlan(NamedTuple):
    """One instance of K3 (csrc/shift_clip.cu) for an [n, h, w] stack."""
    instance: str     # "registers", "shared" or "scratch"
    cap: int          # register instance: frames held (0 otherwise)
    block_rows: int   # blocks of 32 x block_rows threads
    smem_bytes: int   # dynamic shared memory a block (shared instance)
    band_rows: int    # output rows a launch (the scratch's band), else h


def _clip_plan(n: int, h: int, w: int) -> ClipPlan:
    """The instance of K3 for n frames of h x w: registers at CAP = n
    rounded up to a multiple of 4 for n ≤ 32; two shared-memory columns
    of n floats a thread for 33..128 frames, in blocks of 32 x 8, or
    32 x 4 where 8 rows would pass MAX_SHARED_BYTES; past that the
    frame-order column in a global scratch [n, band_rows, w], the band
    as many rows as keep it within SCRATCH_MAX_BYTES (at least one)."""
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"shift_clip_onepass: empty stack {n}x{h}x{w}")
    if n <= MAX_REG_FRAMES:
        return ClipPlan("registers", -(-n // 4) * 4, 8, 0, h)
    if n <= MAX_SHARED_FRAMES:
        rows = 8 if 2 * n * 4 * 32 * 8 <= MAX_SHARED_BYTES else 4
        return ClipPlan("shared", 0, rows, 2 * n * 4 * 32 * rows, h)
    band = max(1, min(h, SCRATCH_MAX_BYTES // (n * 4 * w)))
    return ClipPlan("scratch", 0, 8, 0, band)


def shift_clip_onepass_plain(stack: torch.Tensor, dys, dxs,
                             sigma_low: float = 3.0, sigma_high: float = 3.0,
                             max_iter: int = 5):
    """shift_bicubic_batch + sigma_clip_core, in torch."""
    return sigma_clip_core(shift_bicubic_batch(stack, dys, dxs), sigma_low,
                           sigma_high, max_iter)


def shift_clip_maps(stack: torch.Tensor, dys, dxs, sigma_low: float = 3.0,
                    sigma_high: float = 3.0, max_iter: int = 5):
    """K3 on a CUDA stack [N, H, W]: (combined [H, W] f32, rejected
    [H, W] i32, the plan it ran)."""
    K.require_cuda(stack, "stack", 3)
    n, h, w = stack.shape
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    plan = _clip_plan(n, h, w)
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
    scratch = torch.empty((n, plan.band_rows, w), dtype=torch.float32,
                          device=stack.device) \
        if plan.instance == "scratch" else None
    for y0 in range(0, h, plan.band_rows):
        K.launch("abt_shift_clip", stack.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), n, h, w, float(sigma_low), float(sigma_high),
                 int(max_iter), plan.cap, plan.block_rows, y0,
                 min(plan.band_rows, h - y0), K.ptr(scratch), out.data_ptr(),
                 rejected.data_ptr(), K.stream_handle(stack))
        shift_clip_onepass.launches += 1
    return out, rejected, plan


def shift_clip_onepass(stack: torch.Tensor, dys, dxs,
                       sigma_low: float = 3.0, sigma_high: float = 3.0,
                       max_iter: int = 5):
    """Shift frame k of [N, H, W] by (dys[k], dxs[k]) bicubically, then
    sigma-clip combine over the frames. Returns (combined [H, W] f32,
    rejected: 0-d int64 tensor)."""
    if not K.use_kernel(stack, "shift_clip_onepass"):
        return shift_clip_onepass_plain(stack, dys, dxs, sigma_low,
                                        sigma_high, max_iter)
    out, rejected, _ = shift_clip_maps(stack, dys, dxs, sigma_low,
                                       sigma_high, max_iter)
    return out, rejected.sum()


shift_clip_onepass.launches = 0
