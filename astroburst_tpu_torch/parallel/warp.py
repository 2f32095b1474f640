"""Row-sharded affine warp (counterpart of
astroburst_tpu/parallel/warp.py).

The JAX function shards its shear-decomposed warp (a TPU workaround
for slow gathers, which the port does not carry) with one all-to-all
between the passes. The port's warp is the direct 4×4 Catmull-Rom
sampler (``alignment/affine._warp_direct``, affine.rs:663-690), whose
output rows are independent given the input: each shard computes its
block of output rows from a replicated copy of the input, with no
collective, bit-equal to ``alignment/affine.warp_image`` for every
transform that is not a pure translation onto the same canvas (which
``warp_image`` sends to the separable shift).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, block_bounds,
                                                on_shards)


def make_sharded_warp(mesh: Mesh, transform, out_rows: int, out_cols: int,
                      axis_name="rows"):
    """A warp for a concrete AffineTransform: ``warp(image [H, W])`` →
    warped [out_rows, out_cols] as a Sharded of row blocks over
    ``axis_name`` (ceil(out_rows / P) rows each, the last ones shorter);
    outside the source → 0. The input is broadcast to every shard."""
    from astroburst_tpu_torch.alignment.affine import _warp_direct

    axes = mesh.axes(axis_name)
    bounds = block_bounds(out_rows, mesh.extent(axes))

    def warp(image: torch.Tensor) -> Sharded:
        params = torch.tensor(transform.as_tuple(), dtype=torch.float32)
        images = mesh.broadcast(image.to(torch.float32))

        def run(i, img):
            r0, r1 = bounds[mesh.index(i, axes)]
            return _warp_direct(img, params.to(img.device), r1 - r0,
                                out_cols, row0=r0)

        return Sharded(mesh, on_shards(mesh, run, images), 0, axes,
                       out_rows)

    return warp
