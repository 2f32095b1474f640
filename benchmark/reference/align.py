"""Coarse-to-fine FFT phase correlation of a stack against its frame 0.

Hann-windowed, zero-padded to powers of two, ε-guarded cross-power,
peak with an SNR confidence, circular unwrap and the 3-point parabola
vertex (clamped to ±0.5). Planes past 512 on an axis are first
correlated on box-mean surfaces (box ceil(H/512) x ceil(W/512) over
the largest divisible region), which seed one 512² refine crop a
target, its origin rounded to the nearest multiple of (8, 128). A
frame whose finite pixels number under 16 or span under 1e-10 gets
offset and confidence 0.
"""

from __future__ import annotations

import numpy as np
import torch

COARSE_MAX_DIM = 512
REFINE = 512
EPS = 1e-15


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _hann(n: int, device) -> torch.Tensor:
    if n == 1:
        return torch.ones(1, device=device)
    i = np.arange(n)
    w = (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)
    return torch.from_numpy(w).to(device)


def _frame_stats(x: torch.Tensor):
    fin = torch.isfinite(x)
    inf = torch.full_like(x, float("inf"))
    return (torch.where(fin, x, inf).amin(dim=(-2, -1)),
            torch.where(fin, x, -inf).amax(dim=(-2, -1)),
            fin.sum(dim=(-2, -1)))


def _bad(mn, mx, cnt) -> torch.Tensor:
    return (cnt < 16) | (torch.abs(mx - mn) < 1e-10)


def _windowed(img: torch.Tensor, fr: int, fc: int) -> torch.Tensor:
    rows, cols = img.shape[-2:]
    vals = torch.where(torch.isfinite(img), img, torch.zeros_like(img))
    vals = vals * _hann(rows, img.device)[:, None] * \
        _hann(cols, img.device)[None, :]
    return torch.nn.functional.pad(vals, (0, fc - cols, 0, fr - rows))


def _vertex(prev, center, nxt):
    denom = 2.0 * (2.0 * center - prev - nxt)
    small = torch.abs(denom) < 1e-15
    off = torch.where(small, torch.zeros_like(denom),
                      (nxt - prev) / torch.where(small,
                                                 torch.ones_like(denom),
                                                 denom))
    return torch.clamp(off, -0.5, 0.5)


def correlate(a: torch.Tensor, b: torch.Tensor, q):
    """(dy, dx, confidence) of each frame of b [N, R, C] against a."""
    rows, cols = a.shape[-2:]
    fr, fc = _pow2(rows), _pow2(cols)
    fa = torch.fft.rfft2(_windowed(a, fr, fc))
    fb = torch.stack([torch.fft.rfft2(_windowed(b[i], fr, fc))
                      for i in range(b.shape[0])])
    pr = fb.real * fa.real + fb.imag * fa.imag
    pi = fb.imag * fa.real - fb.real * fa.imag
    inv = 1.0 / torch.clamp(torch.sqrt(pr * pr + pi * pi), min=EPS)
    spec = torch.complex(pr * inv, pi * inv)
    corr = q(torch.stack([torch.fft.irfft2(spec[i], s=(fr, fc))
                          for i in range(b.shape[0])]))
    flat = corr.reshape(corr.shape[0], -1)
    idx = torch.argmax(flat, dim=1)
    peak = flat.gather(1, idx[:, None])[:, 0]
    n = fr * fc
    s = flat.sum(dim=1)
    mean = s / n
    var = torch.clamp((flat * flat).sum(dim=1) - s * mean, min=0.0) / \
        max(n - 1, 1)
    sigma = torch.sqrt(var)
    conf = torch.where(torch.abs(sigma) < 1e-15, torch.zeros_like(sigma),
                       (peak - mean) / torch.clamp(sigma, min=1e-30))
    py = torch.div(idx, fc, rounding_mode="floor")
    px = idx % fc

    def at(y, x):
        return flat.gather(1, (y * fc + x)[:, None])[:, 0]

    center = at(py, px)
    sub_dy = _vertex(at((py - 1) % fr, px), center, at((py + 1) % fr, px))
    sub_dx = _vertex(at(py, (px - 1) % fc), center, at(py, (px + 1) % fc))
    dy = torch.where(py > fr // 2, py - fr, py).float() + sub_dy
    dx = torch.where(px > fc // 2, px - fc, px).float() + sub_dx
    bad = _bad(*_frame_stats(a)) | _bad(*_frame_stats(b))
    zero = torch.zeros_like(dy)
    return (torch.where(bad, zero, dy), torch.where(bad, zero, dx),
            torch.where(bad, zero, conf))


def _box_mean(stack: torch.Tensor):
    n, h, w = stack.shape
    by, bx = -(-h // COARSE_MAX_DIM), -(-w // COARSE_MAX_DIM)
    r, c = h // by, w // bx
    region = stack[:, :r * by, :c * bx]
    return region.reshape(n, r, by, c, bx).sum(dim=(2, 4)) * (
        1.0 / (by * bx)), by, bx


def phase_correlate(stack: torch.Tensor, q=lambda t: t):
    """(dys, dxs, confidences) f32 [N] of every frame of ``stack``
    [N, H, W] against frame 0 (frame 0 itself: 0, 0, 0)."""
    ref, tgt = stack[0], stack[1:]
    n, rows, cols = tgt.shape
    zeros = torch.zeros(1, dtype=torch.float32, device=stack.device)
    if rows <= COARSE_MAX_DIM and cols <= COARSE_MAX_DIM:
        dy, dx, conf = correlate(ref, tgt, q)
    else:
        ds, by, bx = _box_mean(stack)
        ds = q(ds)
        cdy, cdx, _ = correlate(ds[0], ds[1:], q)
        cy = torch.clamp(torch.round(rows // 2 + cdy * by), 0,
                         rows - 1).to(torch.int64)
        cx = torch.clamp(torch.round(cols // 2 + cdx * bx), 0,
                         cols - 1).to(torch.int64)
        y0 = torch.div(cy - REFINE // 2 + 4, 8, rounding_mode="floor") * 8
        x0 = torch.div(cx - REFINE // 2 + 64, 128,
                       rounding_mode="floor") * 128
        y0 = torch.clamp(y0, 0, (max(rows - REFINE, 0) // 8) * 8)
        x0 = torch.clamp(x0, 0, (max(cols - REFINE, 0) // 128) * 128)
        sr, sc = min(REFINE, rows), min(REFINE, cols)
        crops = torch.stack([tgt[k, int(y0[k]):int(y0[k]) + sr,
                                 int(x0[k]):int(x0[k]) + sc]
                             for k in range(n)])
        ry0 = (max(rows // 2 - REFINE // 2, 0) // 8) * 8
        rx0 = (max(cols // 2 - REFINE // 2, 0) // 128) * 128
        rdy, rdx, conf = correlate(ref[ry0:ry0 + sr, rx0:rx0 + sc],
                                   crops, q)
        dy = (y0 - ry0).float() + rdy
        dx = (x0 - rx0).float() + rdx
        bad = _bad(*_frame_stats(ref[None])) | _bad(*_frame_stats(tgt))
        zero = torch.zeros_like(dy)
        dy, dx, conf = (torch.where(bad, zero, dy),
                        torch.where(bad, zero, dx),
                        torch.where(bad, zero, conf))
    return (torch.cat([zeros, dy]), torch.cat([zeros, dx]),
            torch.cat([zeros, conf]))

