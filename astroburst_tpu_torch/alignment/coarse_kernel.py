"""K1: coarse box-mean downsample with the per-frame validity stats.

Counterpart of astroburst_tpu/alignment/coarse_kernel.py:
coarse_downsample_stack; the CUDA kernel is ``csrc/coarse_box.cu``
(header note there: what bounds it and how it is laid out).

The input is an UNPADDED contiguous [N, H, W] stack (the TPU kernel
read the ingest-padded buffer plus ``true_shape``). Box and region
arithmetic are those of ``_coarse_box_downsample``:
by = ceil(H / max_dim), bx = ceil(W / max_dim), the surface covers the
largest divisible region [H // by · by, W // bx · bx]. The box sums run
in f32 (the TPU kernel cast its inputs to bf16), and a non-finite pixel
makes only its own box non-finite, where the JAX band matmuls make the
whole surface NaN (0 · NaN = NaN).

With ``with_stats`` it also returns the per-frame finite min, max and
count over all H × W pixels — the inputs of
phase_correlation._is_constant_or_zero — from the same read.

``coarse_downsample_stack`` launches the kernel for a CUDA tensor and
runs ``coarse_downsample_stack_plain`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K


def box_plan(h: int, w: int, max_dim: int):
    """(by, bx, ds_r, ds_c) for an [h, w] plane."""
    by = -(-h // max_dim)
    bx = -(-w // max_dim)
    return by, bx, h // by, w // bx


def frame_stats_plain(x: torch.Tensor):
    """Finite (min, max, count) over the last two axes, in torch."""
    fin = torch.isfinite(x)
    inf = torch.full_like(x, float("inf"))
    mn = torch.where(fin, x, inf).amin(dim=(-2, -1))
    mx = torch.where(fin, x, -inf).amax(dim=(-2, -1))
    return mn, mx, fin.sum(dim=(-2, -1), dtype=torch.int32)


def coarse_downsample_stack_plain(stack: torch.Tensor, max_dim: int,
                                  with_stats: bool = False):
    """Plain torch version of ``coarse_downsample_stack``."""
    n, h, w = stack.shape
    by, bx, ds_r, ds_c = box_plan(h, w, max_dim)
    region = stack[:, :ds_r * by, :ds_c * bx]
    ds = region.reshape(n, ds_r, by, ds_c, bx).sum(dim=(2, 4)) * (
        1.0 / (by * bx))
    if not with_stats:
        return ds, by, bx
    return (ds, by, bx, *frame_stats_plain(stack))


def coarse_downsample_stack(stack: torch.Tensor, max_dim: int,
                            with_stats: bool = False):
    """Box-mean downsample of every frame of [N, H, W] to
    [N, H // by, W // bx] in one read of the stack. Returns
    (ds, by, bx), and with ``with_stats`` also per-frame finite
    (min f32 [N], max f32 [N], count i32 [N])."""
    if not K.use_kernel(stack, "coarse_downsample_stack"):
        return coarse_downsample_stack_plain(stack, max_dim, with_stats)
    K.require_cuda(stack, "stack", 3)
    n, h, w = stack.shape
    by, bx, ds_r, ds_c = box_plan(h, w, max_dim)
    dev = stack.device
    out = torch.empty((n, ds_r, ds_c), dtype=torch.float32, device=dev)
    if with_stats:
        pmin = torch.empty((n, ds_r), dtype=torch.float32, device=dev)
        pmax = torch.empty((n, ds_r), dtype=torch.float32, device=dev)
        pcnt = torch.empty((n, ds_r), dtype=torch.int32, device=dev)
        ptrs = (pmin.data_ptr(), pmax.data_ptr(), pcnt.data_ptr())
    else:
        ptrs = (None, None, None)
    K.launch("abt_coarse_box", stack.data_ptr(), n, h, w, by, bx, ds_r,
             ds_c, 1.0 / (by * bx), int(with_stats), out.data_ptr(), *ptrs,
             K.stream_handle(stack))
    coarse_downsample_stack.launches += 1
    if not with_stats:
        return out, by, bx
    return (out, by, bx, pmin.amin(dim=1), pmax.amax(dim=1),
            pcnt.sum(dim=1, dtype=torch.int32))


coarse_downsample_stack.launches = 0
