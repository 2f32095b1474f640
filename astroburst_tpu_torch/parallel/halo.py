"""Row sharding with halo exchange for stencils (counterpart of
astroburst_tpu/parallel/halo.py).

A plane split over mesh rows needs its neighbours' rows for a stencil
(the à trous smooth, the shift's taps). ``exchange_row_halos`` gets
them with two ``ppermute``s; at the image's first and last rows the
halo repeats the edge row, which is the clamped boundary of the
single-device functions, so a stencil on the extended block gives the
same values as on the whole plane.
"""

from __future__ import annotations

from typing import Callable

import torch

from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                                on_shards)


def exchange_row_halos(mesh: Mesh, parts, halo: int, axes,
                       dim: int = 0) -> list:
    """Each shard's block of a plane split along ``dim`` over ``axes``,
    extended by ``halo`` rows of its neighbours on either side (edge
    replicas at the image's edges). Every block must hold at least
    ``halo`` rows."""
    n = mesh.extent(axes)
    short = min(p.shape[dim] for p in parts)
    if short < halo:
        raise ValueError(f"row blocks of {short} rows are smaller than the "
                         f"{halo}-row halo; use fewer shards or a taller "
                         f"image")
    tops = [p.narrow(dim, 0, halo) for p in parts]
    bottoms = [p.narrow(dim, p.shape[dim] - halo, halo) for p in parts]
    # my top rows are the bottom halo of the block above; my bottom rows
    # the top halo of the block below
    from_below = mesh.ppermute(tops, axes, [(i, i - 1) for i in range(1, n)])
    from_above = mesh.ppermute(bottoms, axes,
                               [(i, i + 1) for i in range(n - 1)])

    def extend(i, p):
        b = mesh.index(i, axes)
        reps = [1] * p.ndim
        reps[dim] = halo
        top = from_above[i] if b > 0 else p.narrow(dim, 0, 1).repeat(reps)
        bot = from_below[i] if b < n - 1 else \
            p.narrow(dim, p.shape[dim] - 1, 1).repeat(reps)
        return torch.cat([top, p, bot], dim=dim)

    return on_shards(mesh, extend, parts)


def sharded_stencil_map(x, mesh: Mesh, axis_name,
                        fn: Callable[[torch.Tensor, int], torch.Tensor],
                        halo: int) -> Sharded:
    """``fn(local_with_halo, halo) → local`` over a row-sharded plane:
    ``fn`` gets [h_local + 2·halo, W] and returns [h_local, W]."""
    xs = as_sharded(mesh, x, 0, axis_name, pad_edge=True)
    ext = exchange_row_halos(mesh, xs.parts, halo, xs.axes)
    out = on_shards(mesh, lambda i, e: fn(e, halo), ext)
    return Sharded(mesh, out, 0, xs.axes, xs.length)


def _smooth_rows_clamped(x: torch.Tensor, step: int, lo_valid: int,
                         hi_valid: int) -> torch.Tensor:
    """The 5-tap B3 along rows, indices clamped into [lo_valid,
    hi_valid), summed in ``imaging/wavelet._smooth_axis``'s order."""
    from astroburst_tpu_torch.imaging.wavelet import B3_KERNEL
    base = torch.arange(x.shape[0], device=x.device)
    out = None
    for ki, kv in enumerate(B3_KERNEL):
        idx = torch.clamp(base + (ki - 2) * step, lo_valid, hi_valid - 1)
        term = kv * torch.index_select(x, 0, idx)
        out = term if out is None else out + term
    return out


def sharded_atrous_smooth(x, mesh: Mesh, axis_name, step: int) -> Sharded:
    """Row-sharded à trous B3 smooth, bit-equal to
    ``imaging/wavelet.atrous_smooth``: the column pass is local, the row
    pass exchanges 2·step halo rows and clamps at the image's edges
    (there the halo repeats the edge row)."""
    from astroburst_tpu_torch.imaging.wavelet import _smooth_axis

    xs = as_sharded(mesh, x, 0, axis_name, pad_edge=True)
    halo = 2 * step
    cols = on_shards(mesh, lambda i, p: _smooth_axis(p, step, 1), xs.parts)
    ext = exchange_row_halos(mesh, cols, halo, xs.axes)

    def rows(i, e):
        local = e.shape[0] - 2 * halo
        return _smooth_rows_clamped(e, step, 0, e.shape[0])[halo:halo + local]

    return Sharded(mesh, on_shards(mesh, rows, ext), 0, xs.axes, xs.length)
