"""Boundary index modes and point samplers (counterpart of
astroburst_tpu/ops/boundary.py).

Reference: src-tauri/src/core/imaging/boundary.rs (clamp/wrap/reflect)
and src-tauri/src/core/imaging/sampling.rs (nearest/bilinear/bicubic
point samplers). Vectorized over coordinate tensors on the image's
device; each sample is an advanced-index gather.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.resample import catmull_rom


def clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(idx, 0, n - 1)


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(idx, n)


def reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Mirror without repeating the edge (boundary.rs:33-53)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m < n, m, period - m)


def resolve_index(idx: torch.Tensor, n: int, mode: str = "clamp"):
    if mode == "wrap":
        return wrap_index(idx, n)
    if mode == "reflect":
        return reflect_index(idx, n)
    return clamp_index(idx, n)


def _coords(img: torch.Tensor, ys, xs):
    ys = torch.as_tensor(ys, dtype=torch.float32, device=img.device)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=img.device)
    return torch.broadcast_tensors(ys, xs)


def nearest_sample(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """Nearest-neighbour point samples at fractional coordinates
    (sampling.rs:17-24); round half to even, as jnp.round."""
    h, w = img.shape
    ys, xs = _coords(img, ys, xs)
    iy = clamp_index(torch.round(ys).to(torch.int64), h)
    ix = clamp_index(torch.round(xs).to(torch.int64), w)
    return img[iy, ix]


def bilinear_sample(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """Bilinear point samples with clamped corners (sampling.rs:27-49)."""
    h, w = img.shape
    ys, xs = _coords(img, ys, xs)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0).to(img.dtype)
    fx = (xs - x0).to(img.dtype)
    yi, xi = y0.to(torch.int64), x0.to(torch.int64)
    r0, r1 = clamp_index(yi, h), clamp_index(yi + 1, h)
    c0, c1 = clamp_index(xi, w), clamp_index(xi + 1, w)
    v00, v01 = img[r0, c0], img[r0, c1]
    v10, v11 = img[r1, c0], img[r1, c1]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def bicubic_sample(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """Catmull-Rom point samples with clamped taps (sampling.rs:52-81):
    four row taps, each the sum of its four column taps, summed in the
    JAX function's order."""
    h, w = img.shape
    ys, xs = _coords(img, ys, xs)
    iy = torch.floor(ys).to(torch.int64)
    ix = torch.floor(xs).to(torch.int64)
    fy = ys - torch.floor(ys)
    fx = xs - torch.floor(xs)
    out = torch.zeros(ys.shape, dtype=img.dtype, device=img.device)
    for j in range(4):
        wy = catmull_rom(fy - (j - 1))
        row = clamp_index(iy + (j - 1), h)
        row_val = torch.zeros_like(out)
        for i in range(4):
            wx = catmull_rom(fx - (i - 1))
            col = clamp_index(ix + (i - 1), w)
            row_val = row_val + wx * img[row, col]
        out = out + wy * row_val
    return out
