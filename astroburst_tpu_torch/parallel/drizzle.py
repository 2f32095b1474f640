"""Row-sharded drizzle over a mesh (counterpart of
astroburst_tpu/parallel/drizzle.py).

Drizzle's output rows are independent given the input frames: each
band of output rows gathers from a bounded window of input rows. So
the exact banded route (``stacking/drizzle._drizzle_kernel_exact``,
kernel K7 per band) splits over output rows with no collective beyond
the input's broadcast and one ``psum`` of the rejected count. Each
shard takes a block of whole bands and passes its first row as
``row0_offset``, so every band keeps its global origin (ROADMAP C11:
the result depends on the band origins): the image, the weight map
and the rejected count are bit-equal to the unsharded call. The blocks
are ceil(bands / shards) bands each, the last ones shorter or empty,
so the bands are the unsharded call's, no more.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.dtypes import DrizzleKernel
from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, block_bounds,
                                                on_shards)


def sharded_drizzle(mesh: Mesh, stack: torch.Tensor, d_ys, d_xs,
                    scale: float, pixfrac: float, kernel: DrizzleKernel,
                    out_rows: int, out_cols: int, sigma_low: float,
                    sigma_high: float, sigma_iterations: int,
                    axis_name="rows", band_rows: int = 64):
    """Exact drizzle with output rows sharded over ``axis_name``; the
    stack [N, H, W] is broadcast to every shard. Returns (image and
    weight map: Sharded rows of [out_rows, out_cols], rejected: 0-d
    int64 on the first shard's device), equal to
    ``_drizzle_kernel_exact`` with the same ``band_rows``."""
    from astroburst_tpu_torch.stacking.drizzle import _drizzle_kernel_exact

    axes = mesh.axes(axis_name)
    n_bands = -(-out_rows // band_rows)
    bands = block_bounds(n_bands, mesh.extent(axes))
    dev = stack.device
    offsets = torch.stack([torch.as_tensor(d, dtype=torch.float32,
                                           device=dev).reshape(-1)
                           for d in (d_ys, d_xs)])
    stacks = mesh.broadcast(stack)
    offs = mesh.broadcast(offsets)

    def run(i, st, off):
        b0, b1 = bands[mesh.index(i, axes)]
        r0, r1 = b0 * band_rows, min(b1 * band_rows, out_rows)
        if r1 <= r0:
            empty = torch.empty((0, out_cols), dtype=torch.float32,
                                device=st.device)
            return empty, empty.clone(), torch.zeros(
                (), dtype=torch.int64, device=st.device)
        return _drizzle_kernel_exact(
            st, off[0], off[1], scale, pixfrac, kernel, r1 - r0, out_cols,
            sigma_low, sigma_high, sigma_iterations, band_rows,
            row0_offset=r0)

    res = on_shards(mesh, run, stacks, offs)
    rejected = mesh.psum([r[2] for r in res], axes)
    return (Sharded(mesh, [r[0] for r in res], 0, axes, out_rows),
            Sharded(mesh, [r[1] for r in res], 0, axes, out_rows),
            rejected[0])
