"""Subpixel shift and area downsample (counterpart of
astroburst_tpu/ops/resample.py).

Catmull-Rom with clamped taps (sampling.rs:4-13, 51-80), zero where
the source centre falls outside [-0.5, n-0.5] (align.rs:36-57), and
the raw image for an exact zero shift (align.rs:37-39). The separable
order is the JAX one: four row taps summed first, then four column
taps. These functions are also the plain version of the shift half of
the fused shift+clip kernel (stacking/onepass_kernel.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
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


def shift_bicubic_batch(stack: torch.Tensor, dys, dxs, *, out_off: int = 0,
                        grow0: int = 0, gh: int | None = None
                        ) -> torch.Tensor:
    """Per-frame global shifts of a [N, H, W] stack:
    out[k, y, x] = bicubic(stack[k], y + dys[k], x + dxs[k]).

    A row slab (parallel/pipeline.py) passes ``out_off`` (its halo): the
    output is its rows [out_off, H - out_off), the taps clamp to the
    slab's rows, and output row r is global row ``grow0 + r`` of an
    image of ``gh`` rows for the outside-source mask. The defaults are
    the whole stack."""
    n, rows, cols = stack.shape
    out_rows = rows - 2 * out_off
    gh = rows if gh is None else gh
    dev = stack.device
    dy = as_offsets(dys, n, dev)
    dx = as_offsets(dxs, n, dev)
    ky = torch.floor(dy).to(torch.int64)
    kx = torch.floor(dx).to(torch.int64)
    fy = dy - ky.to(torch.float32)
    fx = dx - kx.to(torch.float32)
    ar = torch.arange(out_rows, device=dev)
    ac = torch.arange(cols, device=dev)

    tmp = None
    for j in range(4):
        w = catmull_rom(fy - (j - 1))[:, None, None]
        idx = torch.clamp(ar[None, :] + (ky[:, None] + (out_off + j - 1)),
                          0, rows - 1)
        take = torch.gather(stack, 1,
                            idx[:, :, None].expand(n, out_rows, cols))
        term = w * take
        tmp = term if tmp is None else tmp + term
    out = None
    for i in range(4):
        w = catmull_rom(fx - (i - 1))[:, None, None]
        idx = torch.clamp(ac[None, :] + kx[:, None] + (i - 1), 0, cols - 1)
        take = torch.gather(tmp, 2, idx[:, None, :].expand(n, out_rows,
                                                           cols))
        term = w * take
        out = term if out is None else out + term

    sy = (ar + grow0).to(torch.float32)[None, :, None] + dy[:, None, None]
    sx = ac.to(torch.float32)[None, None, :] + dx[:, None, None]
    inside = ((sy >= -0.5) & (sy <= gh - 0.5) &
              (sx >= -0.5) & (sx <= cols - 0.5))
    shifted = torch.where(inside, out, torch.zeros((), device=dev))
    # the reference returns the image untouched for a true zero shift —
    # zero-weight taps would otherwise bleed NaN around dead pixels
    exact_zero = (torch.abs(dy) < 1e-12) & (torch.abs(dx) < 1e-12)
    return torch.where(exact_zero[:, None, None],
                       stack[:, out_off:out_off + out_rows], shifted)


def shift_bicubic(img: torch.Tensor, dy, dx) -> torch.Tensor:
    """out[y, x] = bicubic(img, y + dy, x + dx) for one [H, W] plane."""
    return shift_bicubic_batch(img[None], dy, dx)[0]


@lru_cache(maxsize=None)
def _box_edges(n_in: int, n_out: int):
    """Per-output-box [y0, y1) bounds, host f64 exact
    (downsample.rs:19-27 edge semantics)."""
    scale = n_in / n_out
    y0 = np.empty(n_out, np.float32)
    y1 = np.empty(n_out, np.float32)
    for o in range(n_out):
        y0[o] = min(max(int(np.floor(o * scale)), 0), n_in - 1)
        y1_raw = int(np.ceil((o + 1) * scale))
        y1[o] = 0 if y1_raw <= 0 else min(y1_raw, n_in)
    return y0, y1


def _box_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] 0/1 box-membership matrix, built on ``device`` from
    the host edge vectors."""
    y0, y1 = (torch.from_numpy(e).to(device)[:, None]
              for e in _box_edges(n_in, n_out))
    j = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    return ((j >= y0) & (j < y1)).to(torch.float32)


def area_downsample(img: torch.Tensor, out_rows: int,
                    out_cols: int) -> torch.Tensor:
    """NaN-aware box-average downsample (counterpart of
    astroburst_tpu/ops/resample.py:area_downsample): the sums of the
    finite values and their counts over each box, as two products with
    0/1 box matrices each (plain ``torch.matmul``, true f32: TF32 is
    off), then sum / count, 0 where a box holds no finite value."""
    in_rows, in_cols = img.shape
    if (in_rows, in_cols) == (out_rows, out_cols):
        return img
    my = _box_matrix(in_rows, out_rows, img.device)
    mx = _box_matrix(in_cols, out_cols, img.device)
    finite = torch.isfinite(img)
    vals = torch.where(finite, img, 0.0)
    s = my @ vals @ mx.T
    c = my @ finite.to(torch.float32) @ mx.T
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)
