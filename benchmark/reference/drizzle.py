"""The exact drizzle with the square kernel (drizzle.rs semantics).

Input pixel ix of frame f, moved by d_f, has its centre at
c = (ix + d_f) * scale in output coordinates and half-width
half = pixfrac * scale / 2; it pushes onto output cell o when
floor(c - half) <= o <= ceil(c + half), with weight the overlap of
[c - half, c + half] with [o, o + 1] on each axis (the product of the
two). Each output pixel keeps its first cap = max(2 n, 4) pushes of
weight above 1e-12 and finite value, in push order (frame, y tap, x
tap); it clips them while 3 or more remain and the last pass cut one
(median and MAD as the mean of the two middle ranks, sigma = 1.4826
MAD), and takes the unweighted mean of the survivors (ascending), or
the mean of all when none survive; the weight map is the sum of the
kept pushes' weights in push order. The output is worked out in
bands of output rows, each band as the drizzle of a vertically moved
grid (d_y - r0 / scale), as the program bands it.
"""

from __future__ import annotations

import math

import torch

MAD_TO_SIGMA = 1.4826
PRESENT = 1e-12


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    return a / torch.full_like(a, s)


def _taps(n_out: int, n_in: int, d: torch.Tensor, scale: float,
          half: float):
    """(index [n, taps, n_out] int64, weight [n, taps, n_out] f32)."""
    taps = max(1, math.ceil((1.0 + 2.0 * half) / scale - 1e-9))
    o = torch.arange(n_out, dtype=torch.float32, device=d.device)[None, :]
    base = torch.floor(_div(o - half, scale) - d[:, None]).to(
        torch.int64) + 1
    idxs, ws = [], []
    for t in range(taps):
        ix = base + t
        inside = (ix >= 0) & (ix <= n_in - 1)
        c = (ix.to(torch.float32) + d[:, None]) * scale
        in_range = (o >= torch.floor(c - half)) & (o <= torch.ceil(c + half))
        w = torch.clamp(torch.minimum(c + half, o + 1.0)
                        - torch.maximum(c - half, o), min=0.0)
        ws.append(torch.where(inside & in_range, w, 0.0))
        idxs.append(torch.clamp(ix, 0, n_in - 1))
    return torch.stack(idxs, dim=1), torch.stack(ws, dim=1)


def _mid(arr, r1, r2, cnt):
    def at(r):
        return torch.gather(arr, 0, torch.clamp(r, 0, arr.shape[0] - 1)[None])[0]
    return torch.where(cnt > 0, (at(r1) + at(r2)) * 0.5, 0.0)


def _finalize(vals, weights, cap: int, sigma_low: float, sigma_high: float,
              iterations: int):
    present = weights > PRESENT
    order = torch.cumsum(present, dim=0, dtype=torch.int32)
    capped = present & (order <= cap)
    wmap = torch.zeros(weights.shape[1:], dtype=torch.float32,
                       device=weights.device)
    for k in range(weights.shape[0]):
        wmap = wmap + torch.where(capped[k], weights[k], 0.0)
    count0 = capped.sum(dim=0)
    sv = torch.sort(torch.where(capped, vals, float("inf")),
                    dim=0).values[:cap]
    p = sv.shape[0]
    iota = torch.arange(p, device=sv.device)[:, None, None]
    lo = torch.zeros_like(count0)
    hi = count0
    stopped = torch.zeros(count0.shape, dtype=torch.bool,
                          device=count0.device)
    for _ in range(iterations):
        cnt = hi - lo
        r1 = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
        r2 = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
        med = _mid(sv, lo + r1, lo + r2, cnt)
        window = (iota >= lo) & (iota < hi)
        dv = torch.sort(torch.where(window, torch.abs(sv - med),
                                    float("inf")), dim=0).values
        sigma = torch.clamp(_mid(dv, r1, r2, cnt) * MAD_TO_SIGMA, min=1e-10)
        active = (cnt >= 3) & ~stopped
        cut_lo = (window & (sv < med - sigma_low * sigma)).sum(dim=0)
        cut_hi = (window & (sv > med + sigma_high * sigma)).sum(dim=0)
        lo = torch.where(active, lo + cut_lo, lo)
        hi = torch.where(active, hi - cut_hi, hi)
        stopped = stopped | (active & (cut_lo + cut_hi == 0))
    final = hi - lo
    kept = torch.zeros(count0.shape, dtype=torch.float32,
                       device=count0.device)
    every = torch.zeros_like(kept)
    for j in range(p):
        kept = kept + torch.where((j >= lo) & (j < hi), sv[j], 0.0)
        every = every + torch.where(j < count0, sv[j], 0.0)
    out = torch.where(final > 0,
                      kept / torch.clamp(final.to(torch.float32), min=1.0),
                      torch.where(count0 > 0, every / torch.clamp(
                          count0.to(torch.float32), min=1.0), 0.0))
    return out, wmap, int((count0 - final).sum())


def drizzle(stack: torch.Tensor, offsets, scale: float, pixfrac: float,
            sigma_low: float, sigma_high: float, iterations: int,
            band_rows: int = 64, q=lambda t: t):
    """(image, weight map, rejected count) of the square-kernel exact
    drizzle of ``stack`` [n, H, W]; ``offsets`` the (dy, dx) of each
    frame against frame 0 (host floats), as the alignment gives them."""
    n, in_rows, in_cols = stack.shape
    dev = stack.device
    scale = min(max(scale, 1.0), 4.0)
    pixfrac = min(max(pixfrac, 0.1), 1.0)
    half = pixfrac * scale * 0.5
    out_rows, out_cols = math.ceil(in_rows * scale), math.ceil(in_cols * scale)
    cap = max(n * 2, 4)
    d_ys = torch.tensor([-dy for dy, _ in offsets], dtype=torch.float32,
                        device=dev)
    d_xs = torch.tensor([-dx for _, dx in offsets], dtype=torch.float32,
                        device=dev)
    idx, wx = _taps(out_cols, in_cols, d_xs, scale, half)
    n_bands = -(-out_rows // band_rows)
    r0s = _div(torch.arange(n_bands, dtype=torch.float32, device=dev)
               * band_rows, scale)
    img = torch.empty((n_bands * band_rows, out_cols), device=dev)
    wgt = torch.empty_like(img)
    rejected = 0
    f = torch.arange(n, device=dev)[:, None, None, None, None]
    for b in range(n_bands):
        idy, wy = _taps(band_rows, in_rows, d_ys - r0s[b], scale, half)
        ty, tx = idy.shape[1], idx.shape[1]
        cand = stack[f, idy[:, :, None, :, None], idx[:, None, :, None, :]]
        cand = cand.reshape(n * ty * tx, band_rows, out_cols)
        w = (wy[:, :, None, :, None] * wx[:, None, :, None, :]).reshape(
            n * ty * tx, band_rows, out_cols)
        finite = torch.isfinite(cand)
        bi, bw, br = _finalize(torch.where(finite, cand, 0.0),
                               torch.where(finite, w, 0.0), cap, sigma_low,
                               sigma_high, iterations)
        rows = slice(b * band_rows, (b + 1) * band_rows)
        img[rows] = q(bi)
        wgt[rows] = q(bw)
        rejected += br
    return img[:out_rows], wgt[:out_rows], rejected
