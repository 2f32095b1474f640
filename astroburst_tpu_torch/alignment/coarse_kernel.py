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
runs ``coarse_downsample_stack_plain`` for a CPU tensor. With ``out``
both write into buffers the caller owns (the phase correlation's CUDA
graphs read them) and leave the per-row stats unreduced:
``reduce_row_stats`` reduces them.
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


def reduce_row_stats(pmin: torch.Tensor, pmax: torch.Tensor,
                     pcnt: torch.Tensor):
    """Per-frame (min, max, count) from the [N, ds_r] per-row partials."""
    return (pmin.amin(dim=1), pmax.amax(dim=1),
            pcnt.sum(dim=1, dtype=torch.int32))


def _check_out(out, n: int, ds_r: int, ds_c: int, device) -> None:
    shapes = [(n, ds_r, ds_c), (n, ds_r), (n, ds_r), (n, ds_r)]
    dtypes = [torch.float32] * 3 + [torch.int32]
    for t, shape, dtype in zip(out, shapes, dtypes):
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != device or not t.is_contiguous():
            raise ValueError(f"out buffers must be contiguous {shapes} "
                             f"{dtypes} on {device}")


def coarse_downsample_stack_plain(stack: torch.Tensor, max_dim: int,
                                  with_stats: bool = False, out=None):
    """Plain torch version of ``coarse_downsample_stack``. With ``out``
    each frame's stats go into its first per-row slot, and the
    reductions' identities into the others."""
    n, h, w = stack.shape
    by, bx, ds_r, ds_c = box_plan(h, w, max_dim)
    region = stack[:, :ds_r * by, :ds_c * bx]
    ds = region.reshape(n, ds_r, by, ds_c, bx).sum(dim=(2, 4)) * (
        1.0 / (by * bx))
    if out is not None:
        _check_out(out, n, ds_r, ds_c, stack.device)
        out[0].copy_(ds)
        for part, ident, stat in zip(out[1:], (float("inf"),
                                               float("-inf"), 0),
                                     frame_stats_plain(stack)):
            part.fill_(ident)
            part[:, 0] = stat
        return (out[0], by, bx, *out[1:])
    if not with_stats:
        return ds, by, bx
    return (ds, by, bx, *frame_stats_plain(stack))


def coarse_downsample_stack(stack: torch.Tensor, max_dim: int,
                            with_stats: bool = False, out=None):
    """Box-mean downsample of every frame of [N, H, W] to
    [N, H // by, W // bx] in one read of the stack. Returns
    (ds, by, bx), and with ``with_stats`` also per-frame finite
    (min f32 [N], max f32 [N], count i32 [N]).

    ``out``, if given, is (ds, row min, row max, row count): contiguous
    buffers of [N, ds_r, ds_c] f32 and [N, ds_r] f32, f32, i32 on the
    stack's device. The call then only launches the kernel into them and
    returns (ds, by, bx, row min, row max, row count), the stats
    unreduced (``reduce_row_stats``)."""
    if not K.use_kernel(stack, "coarse_downsample_stack"):
        return coarse_downsample_stack_plain(stack, max_dim, with_stats,
                                             out)
    K.require_cuda(stack, "stack", 3)
    n, h, w = stack.shape
    by, bx, ds_r, ds_c = box_plan(h, w, max_dim)
    dev = stack.device
    if out is not None:
        _check_out(out, n, ds_r, ds_c, dev)
        ds, pmin, pmax, pcnt = out
    else:
        ds = torch.empty((n, ds_r, ds_c), dtype=torch.float32, device=dev)
        pmin = pmax = pcnt = None
        if with_stats:
            pmin = torch.empty((n, ds_r), dtype=torch.float32, device=dev)
            pmax = torch.empty((n, ds_r), dtype=torch.float32, device=dev)
            pcnt = torch.empty((n, ds_r), dtype=torch.int32, device=dev)
    K.launch("abt_coarse_box", stack.data_ptr(), n, h, w, by, bx, ds_r,
             ds_c, 1.0 / (by * bx), int(pmin is not None), ds.data_ptr(),
             K.ptr(pmin), K.ptr(pmax), K.ptr(pcnt), K.stream_handle(stack))
    coarse_downsample_stack.launches += 1
    if out is not None:
        return (ds, by, bx, pmin, pmax, pcnt)
    if not with_stats:
        return ds, by, bx
    return (ds, by, bx, *reduce_row_stats(pmin, pmax, pcnt))


coarse_downsample_stack.launches = 0
