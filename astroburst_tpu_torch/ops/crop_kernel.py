"""K2: per-frame crops for the phase-correlation refine stage.

Counterpart of astroburst_tpu/ops/crop_kernel.py:gather_crops; the
CUDA kernel is ``csrc/gather_crops.cu`` (header note there: what
bounds it and how it is laid out). Crop k comes from frame
``frame0 + k`` at origin (y0s[k], x0s[k]), clamped into the plane (an
origin past the plane clamps down as ``jax.lax.dynamic_slice`` clamps
it; a negative one clamps to 0 — the refine origins are never out of
range). The origins stay on the device; on the card they are int64, as
``_refine_origin`` makes them, and the kernel reads them as they are.

``gather_crops`` launches the kernel for a CUDA tensor and runs
``gather_crops_plain`` for a CPU tensor; it never falls back. Both
write into ``out`` where the caller gives one (the phase correlation's
CUDA graphs read it).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K


def _check(stack: torch.Tensor, n_out: int, size_r: int, size_c: int,
           frame0: int) -> None:
    if stack.ndim != 3:
        raise ValueError(f"stack must be [N, H, W], got {tuple(stack.shape)}")
    _, h, w = stack.shape
    if size_r > h or size_c > w or size_r < 1 or size_c < 1:
        raise ValueError(f"crop ({size_r},{size_c}) does not fit the "
                         f"plane ({h},{w})")
    if frame0 < 0 or n_out < 1 or frame0 + n_out > stack.shape[0]:
        raise ValueError(f"{n_out} crops from frame {frame0} exceed the "
                         f"{stack.shape[0]}-frame stack")


def _check_out(out: torch.Tensor, n_out: int, size_r: int, size_c: int,
               device) -> None:
    if tuple(out.shape) != (n_out, size_r, size_c) or \
            out.dtype != torch.float32 or out.device != device or \
            not out.is_contiguous():
        raise ValueError(f"out must be a contiguous f32 "
                         f"{(n_out, size_r, size_c)} tensor on {device}")


def gather_crops_plain(stack: torch.Tensor, y0s: torch.Tensor,
                       x0s: torch.Tensor, size_r: int, size_c: int,
                       frame0: int = 0, out=None) -> torch.Tensor:
    """[len(y0s), size_r, size_c] crops by index arithmetic in torch."""
    n_out = y0s.shape[0]
    _check(stack, n_out, size_r, size_c, frame0)
    if out is not None:
        _check_out(out, n_out, size_r, size_c, stack.device)
        return out.copy_(gather_crops_plain(stack, y0s, x0s, size_r,
                                            size_c, frame0))
    _, h, w = stack.shape
    dev = stack.device
    y0 = torch.clamp(y0s.to(device=dev, dtype=torch.int64), 0, h - size_r)
    x0 = torch.clamp(x0s.to(device=dev, dtype=torch.int64), 0, w - size_c)
    rows = y0[:, None] + torch.arange(size_r, device=dev)[None, :]
    cols = x0[:, None] + torch.arange(size_c, device=dev)[None, :]
    frames = torch.arange(frame0, frame0 + n_out, device=dev)
    return stack[frames[:, None, None], rows[:, :, None], cols[:, None, :]]


def gather_crops(stack: torch.Tensor, y0s: torch.Tensor, x0s: torch.Tensor,
                 size_r: int, size_c: int, frame0: int = 0,
                 out=None) -> torch.Tensor:
    """Crop k = stack[frame0 + k, y0s[k]:+size_r, x0s[k]:+size_c]. On the
    card the origins are int64 and the call makes one launch and
    allocates the output (unless ``out``, a contiguous f32
    [len(y0s), size_r, size_c] tensor, is given), nothing else."""
    if not K.use_kernel(stack, "gather_crops"):
        return gather_crops_plain(stack, y0s, x0s, size_r, size_c, frame0,
                                  out)
    n_out = y0s.shape[0]
    K.require_cuda(stack, "stack", 3)
    _check(stack, n_out, size_r, size_c, frame0)
    K.require_cuda(y0s, "y0s", 1, torch.int64)
    K.require_cuda(x0s, "x0s", 1, torch.int64)
    if x0s.shape != (n_out,) or y0s.device != stack.device or \
            x0s.device != stack.device:
        raise ValueError("y0s and x0s must be 1-D of equal length on the "
                         "stack's device")
    _, h, w = stack.shape
    if out is None:
        out = torch.empty((n_out, size_r, size_c), dtype=torch.float32,
                          device=stack.device)
    else:
        _check_out(out, n_out, size_r, size_c, stack.device)
    K.launch("abt_gather_crops", stack.data_ptr(), y0s.data_ptr(),
             x0s.data_ptr(), n_out, h, w, size_r, size_c, frame0,
             out.data_ptr(), K.stream_handle(stack))
    gather_crops.launches += 1
    return out


gather_crops.launches = 0
