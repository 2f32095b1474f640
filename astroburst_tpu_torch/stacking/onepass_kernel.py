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

``shift_clip_onepass_slab`` is the row-shard entry (TPU:
onepass_kernel.py:491, for parallel/pipeline.py): the same kernel on a
slab [N, local_h + 2·halo, W] whose halo rows hold the neighbours' rows
(replicas of the edge row at the image's edges), with the
outside-source mask in global rows. The port does not clamp offsets,
so the halo is not the TPU's off_max + 2 but ``slab_halo``:
ceil(max |dy|) + 2, the rows the taps can reach.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from astroburst_tpu_torch.ops.resample import as_offsets, shift_bicubic_batch
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace
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
                    sigma_high: float = 3.0, max_iter: int = 5, *,
                    out_off: int = 0, grow0: int = 0,
                    gh: int | None = None, counter=None):
    """K3 on a CUDA stack [N, H, W]: (combined [H, W] f32, rejected
    [H, W] i32, the plan it ran). A slab passes its halo as ``out_off``
    (the output is its rows [out_off, H - out_off)), its first output
    row's global index ``grow0`` and the global height ``gh``; each
    launch adds one to ``counter.launches`` (``shift_clip_onepass``'s
    by default)."""
    K.require_cuda(stack, "stack", 3)
    n, slab_h, w = stack.shape
    h = slab_h - 2 * out_off
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    if out_off < 0 or h < 1 or grow0 < 0:
        raise ValueError(f"slab of {slab_h} rows, halo {out_off}, first "
                         f"row {grow0}")
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
    gh = slab_h if gh is None else gh
    for y0 in range(0, h, plan.band_rows):
        K.launch("abt_shift_clip", stack.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), n, slab_h, w, float(sigma_low),
                 float(sigma_high), int(max_iter), plan.cap,
                 plan.block_rows, y0, min(plan.band_rows, h - y0), out_off,
                 grow0, gh, K.ptr(scratch), out.data_ptr(),
                 rejected.data_ptr(), K.stream_handle(stack))
        (counter or shift_clip_onepass).launches += 1
    return out, rejected, plan


def shift_clip_onepass(stack: torch.Tensor, dys, dxs,
                       sigma_low: float = 3.0, sigma_high: float = 3.0,
                       max_iter: int = 5):
    """Shift frame k of [N, H, W] by (dys[k], dxs[k]) bicubically, then
    sigma-clip combine over the frames. Returns (combined [H, W] f32,
    rejected: 0-d int64 tensor)."""
    with trace.span("stacking.shift_clip"):
        if not K.use_kernel(stack, "shift_clip_onepass"):
            return shift_clip_onepass_plain(stack, dys, dxs, sigma_low,
                                            sigma_high, max_iter)
        out, rejected, _ = shift_clip_maps(stack, dys, dxs, sigma_low,
                                           sigma_high, max_iter)
        return out, rejected.sum()


shift_clip_onepass.launches = 0


def slab_halo(dys) -> int:
    """The halo a slab needs for offsets ``dys`` (host values): the
    rows the Catmull-Rom taps can reach, ceil(max |dy|) + 2."""
    dy = torch.as_tensor(dys, dtype=torch.float32, device="cpu")
    return int(math.ceil(float(dy.abs().max()))) + 2 if dy.numel() else 2


def shift_clip_onepass_slab_plain(slab: torch.Tensor, dys, dxs, halo: int,
                                  grow0: int, gh: int,
                                  sigma_low: float = 3.0,
                                  sigma_high: float = 3.0,
                                  max_iter: int = 5):
    """The slab's shift (taps clamped to the slab, the mask in global
    rows) + sigma_clip_core, in torch."""
    return sigma_clip_core(shift_bicubic_batch(
        slab, dys, dxs, out_off=halo, grow0=grow0, gh=gh), sigma_low,
        sigma_high, max_iter)


def shift_clip_onepass_slab(slab: torch.Tensor, dys, dxs, halo: int,
                            grow0: int, gh: int, sigma_low: float = 3.0,
                            sigma_high: float = 3.0, max_iter: int = 5):
    """K3 on one row shard: ``slab`` [N, local_h + 2·halo, W] holds the
    shard's output rows and ``halo`` rows above and below, filled by
    the caller (neighbours' rows, edge replicas at the image's edges);
    ``grow0`` is the shard's first output row in the image and ``gh``
    the image's height. Returns (combined [local_h, W] f32, rejected:
    0-d int64 tensor).

    ``dys`` and ``dxs`` may be host values (the sharded callers fetch
    the offsets once); the halo is checked against them, so a tensor on
    the card costs one fetch here. Raises when ``halo`` is below
    ``slab_halo(dys)``: a tap would then clamp inside the slab where
    the whole image holds other rows."""
    n = slab.shape[0]
    host_dy = dys.detach().cpu() if isinstance(dys, torch.Tensor) else dys
    need = slab_halo(as_offsets(host_dy, n, torch.device("cpu")))
    if halo < need:
        raise ValueError(f"halo {halo} < ceil(max |dy|) + 2 = {need}")
    if not K.use_kernel(slab, "shift_clip_onepass_slab"):
        return shift_clip_onepass_slab_plain(slab, dys, dxs, halo, grow0,
                                             gh, sigma_low, sigma_high,
                                             max_iter)
    out, rejected, _ = shift_clip_maps(slab, dys, dxs, sigma_low,
                                       sigma_high, max_iter, out_off=halo,
                                       grow0=grow0, gh=gh,
                                       counter=shift_clip_onepass_slab)
    return out, rejected.sum()


shift_clip_onepass_slab.launches = 0
