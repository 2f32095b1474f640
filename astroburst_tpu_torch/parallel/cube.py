"""Sharded IFU-cube collapses (counterpart of
astroburst_tpu/parallel/cube.py).

The spectral axis splits over the mesh: each shard holds a contiguous
block of frames and collapses it; the blocks combine by reductions
only, and the cube never meets on one device. The mean adds the
shards' masked sums and counts (``psum``). The median is exact: each
pixel's rank ceil(n/2) (1-based, over its finite values: the
histogram path's single-rank convention of the JAX function,
stats.rs:100) is found by a bisection over the f32 keys, each round
counting every shard's values at or below the midpoint and
``psum``ming the counts, as ``ops/select.py`` selects one rank. The
JAX function refines a compare-count bracket to range/16⁵ instead
(ROADMAP C31).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.select import (KEY_MAX, KEY_MIN, ROUNDS,
                                             key_to_f32)
from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                                on_shards, shard)


def shard_cube(cube: torch.Tensor, mesh: Mesh, axis_name="frames"
               ) -> Sharded:
    """Place [B, H, W] with the spectral axis split over ``axis_name``
    (blocks of ceil(B / P) frames)."""
    return shard(mesh, cube, 0, axis_name)


def sharded_collapse_mean(cube, mesh: Mesh, axis_name="frames") -> Sharded:
    """NaN-aware mean over the sharded spectral axis (eager.rs:24-26):
    the shards' masked sums and counts ``psum``med. The sums add the
    shards' partial sums in the mesh's order, so the mean equals the
    single-device ``cube/eager.collapse_mean`` to f32 rounding.
    Returns [H, W] on every shard (Sharded, replicated)."""
    cs = as_sharded(mesh, cube, 0, axis_name)
    axes = cs.axes

    def partial(i, x):
        finite = torch.isfinite(x)
        return (torch.where(finite, x, 0.0).sum(dim=0),
                finite.sum(dim=0, dtype=torch.float32))

    parts = on_shards(mesh, partial, cs.parts)
    s = mesh.psum([p[0] for p in parts], axes)
    c = mesh.psum([p[1] for p in parts], axes)
    out = on_shards(mesh, lambda i, a, b: torch.where(
        b > 0, a / torch.clamp(b, min=1.0), 0.0), s, c)
    return Sharded(mesh, out, None, (), 0)


def sharded_collapse_median(cube, mesh: Mesh, axis_name="frames"
                            ) -> Sharded:
    """NaN-aware per-pixel median over the sharded spectral axis: the
    finite value of 1-based rank ceil(n/2), exactly, 0 where a pixel has
    none. Returns [H, W] on every shard (Sharded, replicated)."""
    cs = as_sharded(mesh, cube, 0, axis_name)
    axes = cs.axes
    inf = float("inf")
    vals = on_shards(mesh, lambda i, x: torch.where(torch.isfinite(x), x,
                                                    inf), cs.parts)
    cnt = mesh.psum(on_shards(mesh, lambda i, x: torch.isfinite(x).sum(
        dim=0), cs.parts), axes)
    rank = on_shards(mesh, lambda i, c: torch.clamp(
        torch.div(c + 1, 2, rounding_mode="floor") - 1, min=0), cnt)
    lo = on_shards(mesh, lambda i, c: torch.full_like(c, KEY_MIN), cnt)
    hi = on_shards(mesh, lambda i, c: torch.full_like(c, KEY_MAX), cnt)
    for _ in range(ROUNDS):
        mid = on_shards(mesh, lambda i, a, b: torch.div(
            a + b, 2, rounding_mode="floor"), lo, hi)
        below = mesh.psum(on_shards(mesh, lambda i, v, m: (
            v <= key_to_f32(m)[None]).sum(dim=0), vals, mid), axes)
        left = on_shards(mesh, lambda i, b, k: b > k, below, rank)
        lo = on_shards(mesh, lambda i, t, a, m, b: torch.where(
            t, a, torch.minimum(m + 1, b)), left, lo, mid, hi)
        hi = on_shards(mesh, lambda i, t, m, b: torch.where(t, m, b), left,
                       mid, hi)

    def value(i, a, c):
        v = key_to_f32(a)
        return torch.where((c > 0) & (v != 0.0), v, 0.0)

    return Sharded(mesh, on_shards(mesh, value, lo, cnt), None, (), 0)
