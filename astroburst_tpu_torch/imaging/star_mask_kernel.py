"""K13: the star-mask raster.

Counterpart of astroburst_tpu/imaging/star_mask_kernel.py:
``paint_mask_pallas``; the CUDA kernel is ``csrc/star_mask.cu`` (header
note there: what bounds it and how it is laid out). Each star with
radius > 0 paints the smoothstep soft disk of star_mask.rs:61-98 inside
its 96 × 96 window anchored at round(position), clipped to the plane;
the disks are max-combined.

The kernel takes the records as they are: one block per 128² tile of
the unpadded [h, w] plane culls all of them itself (radius > 0, and the
star's window, the disk's conservative support box and the tile meet)
and paints each survivor's rectangle. The TPU wrapper's star → tile
binning (astroburst_tpu/imaging/star_mask_kernel.py:99-120, a segment
table for scalar prefetch) does not exist here: ``paint_mask`` makes one
launch and allocates its output, nothing else.

The plain version, ``paint_mask_plain``, is the direct per-star window
form of the sequential oracle (tests/test_imaging.py:271-294): the
windows' values a chunk of stars at a time, each chunk by one
``scatter_reduce_(..., "amax")`` into a zero plane. A max over values
≥ 0 does not depend on the order, so it is exact. (The TPU's
``lax.map`` tile raster exists only to work around the TPU.)

``paint_mask`` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it never falls back. Positions must be finite
(the callers zero unpainted slots first, as the JAX package does).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K

TILE = 128
WINDOW = 96
HALF = WINDOW // 2


def _anchors(xs: torch.Tensor, ys: torch.Tensor, h: int, w: int):
    """Window anchors (y0, x0) = clip(round(·), 0, h or w), half to even
    as jnp.round; clipped before the cast, so any finite position is
    safe."""
    y0 = torch.clamp(torch.round(ys), 0, h).to(torch.int32)
    x0 = torch.clamp(torch.round(xs), 0, w).to(torch.int32)
    return y0, x0


def _soft_disk(d2, radius, softness: float):
    """Smoothstep soft disk of star_mask.rs:61-98 at squared distance
    ``d2`` (the f32 expression of imaging/star_mask.py:_soft_disk)."""
    soft_radius = radius + softness
    r2_inner = radius * radius
    r2_outer = soft_radius * soft_radius
    fade = torch.clamp(r2_outer - r2_inner, min=1e-10)
    t = torch.clamp((d2 - r2_inner) / fade, 0.0, 1.0)
    val = torch.where(d2 <= r2_inner, 1.0,
                      torch.where(d2 <= r2_outer,
                                  1.0 - t * t * (3.0 - 2.0 * t), 0.0))
    return torch.where(radius > 0.0, val, 0.0)


PLAIN_CHUNK = 2048   # stars whose windows the plain version holds at once


def paint_mask_plain(xs: torch.Tensor, ys: torch.Tensor,
                     radii: torch.Tensor, softness: float, h: int,
                     w: int) -> torch.Tensor:
    """[h, w] f32 mask: the stars' 96 × 96 windows, PLAIN_CHUNK stars at
    a time, max-combined by ``scatter_reduce_``."""
    dev = xs.device
    plane = torch.zeros(h * w + 1, dtype=torch.float32, device=dev)
    off = torch.arange(WINDOW, dtype=torch.int64, device=dev) - HALF
    for s in range(0, xs.shape[0], PLAIN_CHUNK):
        cx, cy = xs[s:s + PLAIN_CHUNK], ys[s:s + PLAIN_CHUNK]
        y0, x0 = _anchors(cx, cy, h, w)
        rows = y0.to(torch.int64)[:, None] + off            # [k, 96]
        cols = x0.to(torch.int64)[:, None] + off
        dy = rows.to(torch.float32) - cy[:, None]
        dx = cols.to(torch.float32) - cx[:, None]
        d2 = (dx * dx)[:, None, :] + (dy * dy)[:, :, None]  # [k, 96, 96]
        val = _soft_disk(d2, radii[s:s + PLAIN_CHUNK, None, None], softness)
        inside = ((rows >= 0) & (rows < h))[:, :, None] & \
            ((cols >= 0) & (cols < w))[:, None, :]
        idx = torch.where(inside, rows[:, :, None] * w + cols[:, None, :],
                          h * w)
        plane.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1),
                              reduce="amax")
    return plane[:h * w].reshape(h, w)


def paint_mask(xs: torch.Tensor, ys: torch.Tensor, radii: torch.Tensor,
               softness: float, h: int, w: int) -> torch.Tensor:
    """[h, w] star mask from ≤ K star records (window-clipped soft disks,
    max-combined); ``xs``, ``ys``, ``radii`` are [K] f32 on one device."""
    if not K.use_kernel(xs, "paint_mask"):
        return paint_mask_plain(xs, ys, radii, softness, h, w)
    for t, name in ((xs, "xs"), (ys, "ys"), (radii, "radii")):
        K.require_cuda(t, name, 1)
    if not xs.shape == ys.shape == radii.shape:
        raise ValueError(f"xs {tuple(xs.shape)}, ys {tuple(ys.shape)} and "
                         f"radii {tuple(radii.shape)} must be equal")
    if h <= 0 or w <= 0:
        raise ValueError(f"plane {h}x{w} is empty")
    out = torch.empty((h, w), dtype=torch.float32, device=xs.device)
    K.launch("abt_star_mask", xs.data_ptr(), ys.data_ptr(), radii.data_ptr(),
             xs.shape[0], float(softness), h, w, out.data_ptr(),
             K.stream_handle(xs))
    paint_mask.launches += 1
    return out


paint_mask.launches = 0
