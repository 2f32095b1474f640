"""Subpixel shift (counterpart of astroburst_tpu/ops/resample.py).

Catmull-Rom with clamped taps (sampling.rs:4-13, 51-80), zero where
the source centre falls outside [-0.5, n-0.5] (align.rs:36-57), and
the raw image for an exact zero shift (align.rs:37-39). The separable
order is the JAX one: four row taps summed first, then four column
taps. These functions are also the plain version of the shift half of
the fused shift+clip kernel (stacking/onepass_kernel.py).
"""

from __future__ import annotations

import torch


def catmull_rom(t: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom kernel, vectorised (sampling.rs:4-13)."""
    a = torch.abs(t)
    inner = a * a * (1.5 * a - 2.5) + 1.0
    outer = a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0
    return torch.where(a <= 1.0, inner,
                       torch.where(a <= 2.0, outer, torch.zeros_like(a)))


def as_offsets(d, n: int, device: torch.device) -> torch.Tensor:
    """Per-frame offsets (tensor, array or sequence) as f32 [n]."""
    return torch.as_tensor(d, dtype=torch.float32, device=device).reshape(n)


def shift_bicubic_batch(stack: torch.Tensor, dys, dxs) -> torch.Tensor:
    """Per-frame global shifts of a [N, H, W] stack:
    out[k, y, x] = bicubic(stack[k], y + dys[k], x + dxs[k])."""
    n, rows, cols = stack.shape
    dev = stack.device
    dy = as_offsets(dys, n, dev)
    dx = as_offsets(dxs, n, dev)
    ky = torch.floor(dy).to(torch.int64)
    kx = torch.floor(dx).to(torch.int64)
    fy = dy - ky.to(torch.float32)
    fx = dx - kx.to(torch.float32)
    ar = torch.arange(rows, device=dev)
    ac = torch.arange(cols, device=dev)

    tmp = None
    for j in range(4):
        w = catmull_rom(fy - (j - 1))[:, None, None]
        idx = torch.clamp(ar[None, :] + ky[:, None] + (j - 1), 0, rows - 1)
        take = torch.gather(stack, 1, idx[:, :, None].expand(n, rows, cols))
        term = w * take
        tmp = term if tmp is None else tmp + term
    out = None
    for i in range(4):
        w = catmull_rom(fx - (i - 1))[:, None, None]
        idx = torch.clamp(ac[None, :] + kx[:, None] + (i - 1), 0, cols - 1)
        take = torch.gather(tmp, 2, idx[:, None, :].expand(n, rows, cols))
        term = w * take
        out = term if out is None else out + term

    sy = ar.to(torch.float32)[None, :, None] + dy[:, None, None]
    sx = ac.to(torch.float32)[None, None, :] + dx[:, None, None]
    inside = ((sy >= -0.5) & (sy <= rows - 0.5) &
              (sx >= -0.5) & (sx <= cols - 0.5))
    shifted = torch.where(inside, out, torch.zeros((), device=dev))
    # the reference returns the image untouched for a true zero shift —
    # zero-weight taps would otherwise bleed NaN around dead pixels
    exact_zero = (torch.abs(dy) < 1e-12) & (torch.abs(dx) < 1e-12)
    return torch.where(exact_zero[:, None, None], stack, shifted)


def shift_bicubic(img: torch.Tensor, dy, dx) -> torch.Tensor:
    """out[y, x] = bicubic(img, y + dy, x + dx) for one [H, W] plane."""
    return shift_bicubic_batch(img[None], dy, dx)[0]
