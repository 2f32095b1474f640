"""Drizzle stacking (counterpart of astroburst_tpu/stacking/drizzle.py).

Reference: src-tauri/src/core/stacking/drizzle.rs — per input pixel
forward splat onto output pixels with square (exact overlap area),
Gaussian or Lanczos3 kernels truncated to the pixfrac·scale/2 window;
finalize each output pixel with per-pixel median/MAD sigma clipping of
the contribution list, then the unweighted mean of survivors (weights
map = Σw).

The JAX package's gather-side formulation is kept: the frame → output
mapping is a uniform scale plus a per-frame offset and every kernel is
separable, so each frame's contributions come from per-axis tap
vectors (index, weight). The exact mode (the default) takes one
candidate per (frame, y-tap, x-tap) in the reference's push order,
banded over output rows, and finalizes the capped push list per pixel.
Every band runs at once: one tap pass makes the row taps of all bands
(``_band_row_tables``) and the x taps, and ``drizzle_gather_banded``
(stacking/drizzle_gather_kernel.py, csrc/drizzle_banded.cu) gathers
each pixel's candidates from the stack through those tables and
finalizes them as kernel K7 does; on the card no candidate tensor
exists, and on a CPU stack its plain version runs K7's over chunks of
rows. The pre-averaging mode collapses each frame's contributions to
one estimate first; ``drizzle_stack`` routes to it when no output pixel
can receive two contributions of one frame (square kernel,
1 + pixfrac·scale ≤ scale).

Differences from the JAX module, none of them in the arithmetic:

- the tap vectors and candidates are built for all frames at once (the
  JAX code loops over frames; every element is the same f32 formula);
- ``_clip_mean_frames`` sorts with ``torch.sort`` (the JAX bitonic
  networks of ops/sort_network.py are a TPU workaround); the ranks,
  the window shrink and the empty → mean-of-all rule are the same;
- the sums that make an output value (Σw in push order, the survivors
  in ascending order) run in a fixed sequential order, so the plain
  version and kernel K7 give the same bits;
- a division by a configuration scalar divides by a tensor of that
  f32 value: PyTorch may turn a division by a Python scalar on the card
  into a multiplication by its reciprocal, which would move the floor
  of a tap base;
- drizzle alignment by phase correlation runs one
  ``phase_correlate_stack`` call for all frames and fetches the offsets
  once; a frame whose confidence is low then takes the affine route
  (``alignment/pair.estimate_offset(AFFINE)``) on its own, as every
  frame does under the other alignment methods (drizzle.py:727-741).

Band arithmetic is JAX's: each band offsets d_y by ``- r0/scale`` with
``r0`` an f32 multiple of ``band_rows``, so results depend on
``band_rows`` at the 1e-4 level near r0 ≈ 4096 in both packages
(ROADMAP C).

``drizzle_exact_parity`` is the exact route without candidates, for an
integer scale: kernel K9 (stacking/drizzle_gather_kernel.py) gathers
each output pixel's candidates from the stack by per-parity integer
shifts and finalizes them as K7 does. As in the JAX package it is
opt-in: ``drizzle_stack`` does not route to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from astroburst_tpu_torch.alignment.pair import estimate_offset
from astroburst_tpu_torch.alignment.phase_correlation import (
    is_low_confidence, phase_correlate_stack)
from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.dtypes import (AlignMethod, AlignmentMethod,
                                         DrizzleConfig, DrizzleKernel)
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import cuda_device

PRESENT = 1e-12  # a push counts when its weight exceeds this (drizzle.rs)


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / f32(s), as a true division (see the module note)."""
    return a / torch.full_like(a, s)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    pi_x = math.pi * torch.where(ax < 1e-12, 1.0, x)
    val = (torch.sin(pi_x) / pi_x) * (torch.sin(_div(pi_x, 3.0))
                                      / _div(pi_x, 3.0))
    return torch.where(ax < 1e-12, 1.0, torch.where(ax >= 3.0, 0.0, val))


def _support_taps(scale: float, half: float, kernel: DrizzleKernel,
                  exact: bool):
    """Minimal tap count covering every input pixel that can contribute
    to one output cell along one axis, and the base offset:
    (taps, base_off) with base = floor(lower) + base_off
    (drizzle.py:_support_taps, where the geometry is derived)."""
    if kernel == DrizzleKernel.SQUARE:
        width = (1.0 + 2.0 * half) / scale
        return max(1, math.ceil(width - 1e-9)), 1
    if exact:
        width = (2.0 + 2.0 * half) / scale
        return max(1, math.ceil(width - 1e-9)), 1
    width = (2.0 * half + 2.0) / scale
    return math.floor(width + 1e-9) + 2, 0


def _overlap(c, o, half):
    """Square kernel: overlap of [c − half, c + half] with [o, o + 1]."""
    return torch.clamp(torch.minimum(c + half, o + 1.0)
                       - torch.maximum(c - half, o), min=0.0)


def _gaussian(c, o, half):
    sigma = max(half, 0.5)
    t = o + 0.5 - c
    return torch.exp(_div(-(t * t), 2.0 * sigma * sigma))


def _axis_weights(n_out: int, n_in: int, d: torch.Tensor, scale: float,
                  half: float, kernel: DrizzleKernel, taps: int,
                  base_off: int = 0):
    """Gather-form (pre-averaging) taps of one axis for every frame:
    (index [n, taps, n_out] int64, weight [n, taps, n_out] f32), with
    ``d`` the per-frame offsets [n]. Input pixel ix has centre
    c = (ix + d)·scale and half-width ``half`` in output coordinates;
    output pixel o covers [o, o+1)."""
    o = torch.arange(n_out, dtype=torch.float32, device=d.device)[None, :]
    d = d[:, None]
    if kernel == DrizzleKernel.SQUARE:
        lower = _div(o - half, scale) - d
    else:
        lower = _div(o + 0.5 - half - 1.0, scale) - d
    base = torch.floor(lower).to(torch.int64) + base_off
    idxs, ws = [], []
    for t in range(taps):
        ix = base + t
        inside = (ix >= 0) & (ix <= n_in - 1)
        c = (ix.to(torch.float32) + d) * scale
        if kernel == DrizzleKernel.SQUARE:
            w = _overlap(c, o, half)
        else:
            w = _gaussian(c, o, half) if kernel == DrizzleKernel.GAUSSIAN \
                else _lanczos3(o + 0.5 - c)
            w = torch.where(torch.abs(o + 0.5 - c) <= half + 1.0, w, 0.0)
        ws.append(torch.where(inside, w, 0.0))
        idxs.append(torch.clamp(ix, 0, n_in - 1))
    return torch.stack(idxs, dim=1), torch.stack(ws, dim=1)


def _exact_base(n_out: int, d: torch.Tensor, scale: float, half: float,
                kernel: DrizzleKernel, base_off: int) -> torch.Tensor:
    """Input index of tap 0 for every frame and output cell, unclamped:
    [n, n_out] int64 (the push range's lower end, drizzle.rs:75-78)."""
    o = torch.arange(n_out, dtype=torch.float32, device=d.device)[None, :]
    d = d[:, None]
    if kernel == DrizzleKernel.SQUARE:
        lower = _div(o - half, scale) - d
    else:
        lower = _div(o - 1.0 - half, scale) - d
    return torch.floor(lower).to(torch.int64) + base_off


def _axis_taps_exact(n_out: int, n_in: int, d: torch.Tensor, scale: float,
                     half: float, kernel: DrizzleKernel, taps: int,
                     base_off: int):
    """Push-form taps of one axis for every frame, reproducing the
    reference's push set: input pixel ix contributes to output cell o
    iff floor(cx − half) ≤ o ≤ ceil(cx + half) (drizzle.rs:75-78), with
    the kernel weight evaluated at the cell. Returns (index
    [n, taps, n_out] int64, weight [n, taps, n_out] f32)."""
    o = torch.arange(n_out, dtype=torch.float32, device=d.device)[None, :]
    base = _exact_base(n_out, d, scale, half, kernel, base_off)
    d = d[:, None]
    idxs, ws = [], []
    for t in range(taps):
        ix = base + t
        inside = (ix >= 0) & (ix <= n_in - 1)
        c = (ix.to(torch.float32) + d) * scale
        in_range = (o >= torch.floor(c - half)) & (o <= torch.ceil(c + half))
        if kernel == DrizzleKernel.SQUARE:
            w = _overlap(c, o, half)
        elif kernel == DrizzleKernel.GAUSSIAN:
            w = _gaussian(c, o, half)
        else:
            w = _lanczos3(o + 0.5 - c)
        ws.append(torch.where(inside & in_range, w, 0.0))
        idxs.append(torch.clamp(ix, 0, n_in - 1))
    return torch.stack(idxs, dim=1), torch.stack(ws, dim=1)


def _gather(stack: torch.Tensor, idy: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """RAW candidate planes [n·ty·tx, rows, cols] in push order (frame,
    y-tap, x-tap): plane (f, t, u) is stack[f, idy[f, t], idx[f, u]]."""
    n, ty, rows = idy.shape
    tx, cols = idx.shape[1], idx.shape[2]
    f = torch.arange(n, device=stack.device)[:, None, None, None, None]
    cand = stack[f, idy[:, :, None, :, None], idx[:, None, :, None, :]]
    return cand.reshape(n * ty * tx, rows, cols)


def _outer(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """w = wy·wx per candidate plane: [n, ty, rows] × [n, tx, cols] →
    [n·ty·tx, rows, cols] in push order."""
    n, ty, rows = wy.shape
    tx, cols = wx.shape[1], wx.shape[2]
    w = wy[:, :, None, :, None] * wx[:, None, :, None, :]
    return w.reshape(n * ty * tx, rows, cols)


def _exact_taps(n_out: int, n_in: int, ds: torch.Tensor, scale: float,
                pixfrac: float, kernel: DrizzleKernel):
    half = pixfrac * scale * 0.5
    taps, base_off = _support_taps(scale, half, kernel, exact=True)
    return _axis_taps_exact(n_out, n_in, ds, scale, half, kernel, taps,
                            base_off)


def _frame_candidates_raw(stack, d_ys, d_xs, scale: float, pixfrac: float,
                          kernel: DrizzleKernel, out_rows: int,
                          out_cols: int):
    """RAW candidate planes of every frame of ``stack`` [n, H, W] in push
    order, with NaN/inf kept, plus the per-axis tap weights: (cand_v
    [n·taps², out_rows, out_cols], wys [n·taps, out_rows], wxs
    [n·taps, out_cols], taps). Weights are NOT masked by finiteness:
    kernel K7 forms w = wy·wx and presence = finite & (w > 1e-12)
    itself."""
    n, in_rows, in_cols = stack.shape
    idy, wy = _exact_taps(out_rows, in_rows, d_ys, scale, pixfrac, kernel)
    idx, wx = _exact_taps(out_cols, in_cols, d_xs, scale, pixfrac, kernel)
    taps = idy.shape[1]
    return (_gather(stack, idy, idx), wy.reshape(n * taps, out_rows),
            wx.reshape(n * taps, out_cols), taps)


def _masked_candidates(cand_raw: torch.Tensor, w: torch.Tensor):
    """(value, weight) candidate planes as the JAX ``_frame_candidates``
    makes them, kernel K8's input: a non-finite value becomes 0 with
    weight 0."""
    finite = torch.isfinite(cand_raw)
    return (torch.where(finite, cand_raw, 0.0),
            torch.where(finite, w, 0.0))


def _finalize_exact(cand_v, cand_w, cap: int, sigma_low: float,
                    sigma_high: float, iterations: int):
    """The reference finalize (drizzle.rs:121-195) over the ordered
    candidate axis of [m, H, W]: cap at ``cap`` pushes in push order,
    per-pixel median/MAD clip of the surviving individual values,
    unweighted mean; empty → mean of ALL capped values; weights map =
    Σw of the capped pushes, summed in push order. Returns (image f32,
    weight_map f32, rejected map i32)."""
    present = cand_w > PRESENT
    order = torch.cumsum(present, dim=0, dtype=torch.int32)
    capped = present & (order <= cap)
    weight_map = torch.zeros(cand_w.shape[1:], dtype=torch.float32,
                             device=cand_w.device)
    for k in range(cand_w.shape[0]):
        weight_map = weight_map + torch.where(capped[k], cand_w[k], 0.0)
    image, rej = _clip_mean_frames(cand_v, capped, sigma_low, sigma_high,
                                   iterations, depth=cap)
    return image, weight_map, rej


def _at(arr: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """arr[rank[y, x], y, x], ranks clamped into the axis."""
    r = torch.clamp(rank, 0, arr.shape[0] - 1)
    return torch.gather(arr, 0, r[None])[0]


def _rank2(arr, r1, r2, cnt):
    """The even-averaging median (arr@r1 + arr@r2)/2, 0 where cnt is 0."""
    return torch.where(cnt > 0, (_at(arr, r1) + _at(arr, r2)) * 0.5, 0.0)


def _clip_mean_frames(estimates, present, sigma_low: float,
                      sigma_high: float, iterations: int,
                      depth: Optional[int] = None):
    """Sigma clip across the candidate axis with the drizzle-finalize
    semantics (drizzle.rs:121-178): even-averaging medians, a pixel is
    clipped while its window holds ≥ 3 values and its last pass cut
    something, empty → mean of all.

    Sorted-window form: the kept set is an interval in value space, so
    after one ascending sort each pass moves the window bounds
    [lo, hi). ``depth`` bounds the live values per pixel (the cap), so
    only that many sorted entries are kept. Returns (image f32,
    per-pixel rejected map i32)."""
    mask0 = present
    count0 = mask0.sum(dim=0)
    sv = torch.sort(torch.where(mask0, estimates.to(torch.float32),
                                float("inf")), dim=0).values
    if depth is not None:
        sv = sv[:depth]
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
        med = _rank2(sv, lo + r1, lo + r2, cnt)
        window = (iota >= lo) & (iota < hi)
        dv = torch.sort(torch.where(window, torch.abs(sv - med),
                                    float("inf")), dim=0).values
        mad = _rank2(dv, r1, r2, cnt)
        sigma = torch.clamp(mad * MAD_TO_SIGMA, min=1e-10)
        active = (cnt >= 3) & ~stopped
        vlo = med - sigma_low * sigma
        vhi = med + sigma_high * sigma
        cut_lo = (window & (sv < vlo)).sum(dim=0)
        cut_hi = (window & (sv > vhi)).sum(dim=0)
        lo = torch.where(active, lo + cut_lo, lo)
        hi = torch.where(active, hi - cut_hi, hi)
        stopped = stopped | (active & (cut_lo + cut_hi == 0))

    final_cnt = hi - lo
    kept = torch.zeros(count0.shape, dtype=torch.float32,
                       device=count0.device)
    every = torch.zeros_like(kept)
    for j in range(p):   # ascending order, as kernel K7 sums
        kept = kept + torch.where((j >= lo) & (j < hi), sv[j], 0.0)
        every = every + torch.where(j < count0, sv[j], 0.0)
    mean_kept = kept / torch.clamp(final_cnt.to(torch.float32), min=1.0)
    mean_all = every / torch.clamp(count0.to(torch.float32), min=1.0)
    out = torch.where(final_cnt > 0, mean_kept,
                      torch.where(count0 > 0, mean_all, 0.0))
    return out, (count0 - final_cnt).to(torch.int32)


def _drizzle_kernel_exact(stack, d_ys, d_xs, scale: float, pixfrac: float,
                          kernel: DrizzleKernel, out_rows: int,
                          out_cols: int, sigma_low: float,
                          sigma_high: float, sigma_iterations: int,
                          band_rows: int = 64, *, plain: bool = False,
                          row0_offset: int = 0):
    """Exact drizzle: per-(frame, tap) candidates with the reference's
    capped push-list semantics, over bands of ``band_rows`` output rows,
    each the drizzle of a vertically offset output, all in one launch
    (``_drizzle_one_launch``: the bands' row taps from one batched tap
    pass, then ``drizzle_gather_banded``, which gathers each pixel's
    candidates itself and finalizes them as K7 does). ``plain`` runs the
    call in ``runtime/kernels.plain_versions()``. ``row0_offset`` makes
    the call compute rows [row0_offset, row0_offset + out_rows) of the
    whole output grid (the row-sharded drizzle, parallel/drizzle.py): it
    is added to every band's origin, as the JAX function adds it
    (stacking/drizzle.py:302-306). Returns (image [out_rows, out_cols]
    f32, weight map f32, rejected: 0-d int64 tensor, summed over every
    band row as the JAX function sums it)."""
    args = (stack, d_ys, d_xs, scale, pixfrac, kernel, out_rows, out_cols,
            sigma_low, sigma_high, sigma_iterations, band_rows, row0_offset)
    with trace.span("stacking.drizzle"):
        if plain:
            with K.plain_versions():
                return _drizzle_one_launch(*args)
        return _drizzle_one_launch(*args)


def _band_origins(n_bands: int, band_rows: int, row0_offset: int,
                  scale: float, dev) -> torch.Tensor:
    """r0 / scale of every band, f32 [n_bands]."""
    return _div(torch.arange(n_bands, dtype=torch.float32, device=dev)
                * band_rows + float(row0_offset), scale)


def _band_row_tables(in_rows: int, d_ys: torch.Tensor, r0s: torch.Tensor,
                     band_rows: int, scale: float, pixfrac: float,
                     kernel: DrizzleKernel):
    """The row taps of every band from one ``_exact_taps`` call, the
    band offsets broadcast (every element is the per-band call's f32
    formula), laid out per output row of the padded grid: (iy [n_bands ·
    band_rows, n·taps] int32, wys_t [n_bands · band_rows, n·taps] f32,
    taps); row b·band_rows + r, column f·taps + t is band b's tap t of
    frame f at row r."""
    n, n_bands = d_ys.shape[0], r0s.shape[0]
    idy, wy = _exact_taps(band_rows, in_rows,
                          (d_ys[None, :] - r0s[:, None]).reshape(-1), scale,
                          pixfrac, kernel)
    taps = idy.shape[1]

    def per_row(a):
        return (a.reshape(n_bands, n, taps, band_rows).permute(0, 3, 1, 2)
                .reshape(n_bands * band_rows, n * taps).contiguous())
    return per_row(idy.to(torch.int32)), per_row(wy), taps


def _one_launch_tables(stack, d_ys, d_xs, scale: float, pixfrac: float,
                       kernel: DrizzleKernel, out_cols: int, n_bands: int,
                       band_rows: int, row0_offset: int):
    """The tap tables of ``drizzle_gather_banded`` for every band: (iy,
    wys_t, ix [n·taps, out_cols] int32, wxs [n·taps, out_cols] f32,
    taps), ``iy`` and ``wys_t`` from ``_band_row_tables``."""
    n, in_rows, in_cols = stack.shape
    idx, wx = _exact_taps(out_cols, in_cols, d_xs, scale, pixfrac, kernel)
    iy, wys_t, taps = _band_row_tables(
        in_rows, d_ys, _band_origins(n_bands, band_rows, row0_offset, scale,
                                     stack.device),
        band_rows, scale, pixfrac, kernel)
    return (iy, wys_t, idx.reshape(n * taps, out_cols).to(torch.int32),
            wx.reshape(n * taps, out_cols), taps)


def _drizzle_one_launch(stack, d_ys, d_xs, scale, pixfrac, kernel, out_rows,
                        out_cols, sigma_low, sigma_high, sigma_iterations,
                        band_rows, row0_offset):
    """Every band of the exact drizzle at once: one batched tap pass
    (``_one_launch_tables``), then one ``drizzle_gather_banded`` over the
    padded grid (its plain version on a CPU stack). No candidate tensor
    exists."""
    from astroburst_tpu_torch.stacking.drizzle_gather_kernel import (
        drizzle_gather_banded)
    n = stack.shape[0]
    dev = stack.device
    d_ys = torch.as_tensor(d_ys, dtype=torch.float32, device=dev)
    d_xs = torch.as_tensor(d_xs, dtype=torch.float32, device=dev)
    n_bands = -(-out_rows // band_rows)
    trace.count("stacking.drizzle.bands", n_bands)
    with trace.span("stacking.drizzle.taps"):
        tables = _one_launch_tables(stack, d_ys, d_xs, scale, pixfrac,
                                    kernel, out_cols, n_bands, band_rows,
                                    row0_offset)
    with trace.span("stacking.drizzle.gather"):
        img, wgt, rej = drizzle_gather_banded(
            stack, *tables, max(n * 2, 4), sigma_low, sigma_high,
            sigma_iterations)
    return img[:out_rows], wgt[:out_rows], rej.sum(dtype=torch.int64)


def _plan_parity(in_rows: int, in_cols: int, d_ys, d_xs, scale: float,
                 pixfrac: float, kernel: DrizzleKernel, out_rows: int,
                 out_cols: int):
    """Parity plan of the gather+finalize kernel K9
    (stacking/drizzle_gather_kernel.py), or None where it does not
    apply — in exactly the cases of the JAX ``_plan_parity``
    (drizzle.py:493-560).

    For an INTEGER scale S, output index o = S·q + p gives
    floor((S·q + c')/S − d) = q + floor(c'/S − d), so each (frame, tap)
    candidate gather is a pure shift per parity. The identity is
    VERIFIED against the f32 per-cell base indices (at large o the f32
    evaluation can drift across binades): any drift → None. None also
    for a non-integer scale, an output that is not S× the input, and
    shifts that spread over more than 32 px across the frames (the JAX
    span bucket). The tap vectors are the banded route's own
    ``_axis_taps_exact``, in f32 on the CPU (the JAX package's numpy
    copy, ``_np_axis_taps_exact``, is the same formula).

    Returns dict(s, taps, s_row, s_col: [n, S] int32 — tap 0's input
    index at q = 0 per frame and parity; wys_t [out_rows, n·taps] and
    wxs [n·taps, out_cols] f32 — the weights of the full output grid,
    in K7's layout). The JAX plan's block geometry (window origins,
    padded sizes) has no counterpart."""
    s = int(round(scale))
    if abs(scale - s) > 1e-9 or s < 1:
        return None
    if out_rows != in_rows * s or out_cols != in_cols * s:
        return None
    d_ys = torch.as_tensor(d_ys, dtype=torch.float32).cpu().reshape(-1)
    d_xs = torch.as_tensor(d_xs, dtype=torch.float32).cpu().reshape(-1)
    n = d_ys.shape[0]
    half = pixfrac * scale * 0.5
    taps, base_off = _support_taps(scale, half, kernel, exact=True)

    def axis(n_out, n_in, ds):
        base = _exact_base(n_out, ds, scale, half, kernel, base_off)
        par = base.reshape(n, n_out // s, s)          # [n, q, p]
        shifts = par[:, 0, :]
        q = torch.arange(n_out // s)[None, :, None]
        if not torch.equal(par, shifts[:, None, :] + q):
            return None                               # f32 floor drift
        _, w = _axis_taps_exact(n_out, n_in, ds, scale, half, kernel, taps,
                                base_off)
        span = int((shifts.max(dim=0).values - shifts.min(dim=0).values)
                   .max())
        return shifts.to(torch.int32), w.reshape(n * taps, n_out), span

    rows = axis(out_rows, in_rows, d_ys)
    if rows is None:
        return None
    cols = axis(out_cols, in_cols, d_xs)
    if cols is None:
        return None
    if -(-max(rows[2], cols[2], 1) // 8) * 8 > 32:
        return None   # pathological offsets: the general path
    return dict(s=s, taps=taps, s_row=rows[0], s_col=cols[0],
                wys_t=rows[1].T.contiguous(), wxs=cols[1].contiguous())


def _interleave_parity(planes: torch.Tensor, s: int) -> torch.Tensor:
    """[S², h, w] parity planes → [S·h, S·w]: out[S·r + pr, S·c + pc] =
    planes[pr·S + pc][r, c]."""
    _, h, w = planes.shape
    return planes.reshape(s, s, h, w).permute(2, 0, 3, 1).reshape(s * h,
                                                                  s * w)


def drizzle_exact_parity(stack, d_ys, d_xs, scale: float, pixfrac: float,
                         kernel: DrizzleKernel, out_rows: int, out_cols: int,
                         sigma_low: float, sigma_high: float,
                         sigma_iterations: int):
    """Exact drizzle through the parity-decomposed gather+finalize
    kernel K9: no candidate tensor exists. ``d_ys``/``d_xs`` are the
    per-frame offsets (fetched to the host for the plan). Returns
    (image, weight map, rejected: 0-d int64 tensor) — the exact banded
    route's result, with no band offset (``_drizzle_kernel_exact`` at
    one band) — or None where the plan does not apply. Opt-in, as in
    the JAX package: ``drizzle_stack`` does not route here."""
    from astroburst_tpu_torch.stacking.drizzle_gather_kernel import (
        drizzle_gather_finalize)
    n, in_rows, in_cols = stack.shape
    plan = _plan_parity(in_rows, in_cols, d_ys, d_xs, scale, pixfrac,
                        kernel, out_rows, out_cols)
    if plan is None:
        return None
    dev = stack.device
    img, wgt, rej = drizzle_gather_finalize(
        stack, *(plan[k].to(dev) for k in ("s_row", "s_col", "wys_t",
                                           "wxs")),
        plan["taps"], max(2 * n, 4), sigma_low, sigma_high, sigma_iterations)
    return img, wgt, rej.sum(dtype=torch.int64)


def _drizzle_frame(frames, d_ys, d_xs, scale: float, pixfrac: float,
                   kernel: DrizzleKernel, out_rows: int, out_cols: int):
    """(weighted-sum, weight) fields [n, out_rows, out_cols] of every
    frame of [n, H, W], gather-side: one pass along x, one along y."""
    n, in_rows, in_cols = frames.shape
    half = pixfrac * scale * 0.5
    taps, base_off = _support_taps(scale, half, kernel, exact=False)
    finite = torch.isfinite(frames)
    vals = torch.where(finite, frames, 0.0)
    ones = finite.to(torch.float32)
    idx, wx = _axis_weights(out_cols, in_cols, d_xs, scale, half, kernel,
                            taps, base_off)
    idy, wy = _axis_weights(out_rows, in_rows, d_ys, scale, half, kernel,
                            taps, base_off)

    a_val = a_w = None   # pass 1: along x → [n, in_rows, out_cols]
    for t in range(taps):
        gi = idx[:, t, None, :].expand(n, in_rows, out_cols)
        w = wx[:, t, None, :]
        tv = w * torch.gather(vals, 2, gi)
        tw = w * torch.gather(ones, 2, gi)
        a_val = tv if a_val is None else a_val + tv
        a_w = tw if a_w is None else a_w + tw
    o_val = o_w = None   # pass 2: along y → [n, out_rows, out_cols]
    for t in range(taps):
        gi = idy[:, t, :, None].expand(n, out_rows, out_cols)
        w = wy[:, t, :, None]
        tv = w * torch.gather(a_val, 1, gi)
        tw = w * torch.gather(a_w, 1, gi)
        o_val = tv if o_val is None else o_val + tv
        o_w = tw if o_w is None else o_w + tw
    return o_val, o_w


def _drizzle_kernel(stack, d_ys, d_xs, scale: float, pixfrac: float,
                    kernel: DrizzleKernel, out_rows: int, out_cols: int,
                    sigma_low: float, sigma_high: float,
                    sigma_iterations: int):
    """Pre-averaging drizzle: one estimate per frame per output pixel
    (its weighted mean), clipped across frames. Plain torch: the JAX
    package runs this route in XLA, with no Pallas kernel."""
    dev = stack.device
    d_ys = torch.as_tensor(d_ys, dtype=torch.float32, device=dev)
    d_xs = torch.as_tensor(d_xs, dtype=torch.float32, device=dev)
    sums, weights = _drizzle_frame(stack, d_ys, d_xs, scale, pixfrac,
                                   kernel, out_rows, out_cols)
    present = weights > PRESENT
    estimates = torch.where(present,
                            sums / torch.where(present, weights, 1.0), 0.0)
    image, rej_map = _clip_mean_frames(estimates, present, sigma_low,
                                       sigma_high, sigma_iterations)
    return image, weights.sum(dim=0), rej_map.sum(dtype=torch.int64)


@dataclass
class DrizzleResult:
    image: torch.Tensor
    weight_map: torch.Tensor
    frame_count: int
    output_scale: float
    input_dims: Tuple[int, int]
    output_dims: Tuple[int, int]
    offsets: List[Tuple[float, float]]
    rejected_pixels: int


def drizzle_stack(images: Sequence, config: DrizzleConfig = DrizzleConfig(),
                  progress: Optional[object] = None, exact: bool = True,
                  device: Optional[torch.device] = None) -> DrizzleResult:
    """Full drizzle pipeline (drizzle.rs:226-346).

    ``images`` are [H, W] arrays or tensors; they go to ``device``
    (default: the first tensor's device, else ``cuda_device()``).
    ``exact=True`` (default) finalizes the capped candidate list of
    every output pixel (the reference's per-contribution clip);
    ``exact=False`` pre-averages each frame's contributions; the square
    kernel with 1 + pixfrac·scale ≤ scale takes the pre-averaging route
    either way, where the two are identical. ``progress`` is any object
    with ``tick_with_stage`` and ``check_cancelled``."""
    with trace.span("stacking.drizzle_stack"):
        return _drizzle_stack(images, config, progress, exact, device)


def _drizzle_stack(images, config, progress, exact, device):
    if len(images) == 0:
        raise InvalidInput("No images to drizzle")
    if len(images) < 2:
        raise InvalidInput(
            "Drizzle requires at least 2 frames for sub-pixel reconstruction")

    dims = [(int(i.shape[0]), int(i.shape[1])) for i in images]
    min_rows = min(d[0] for d in dims)
    min_cols = min(d[1] for d in dims)
    max_rows = max(d[0] for d in dims)
    max_cols = max(d[1] for d in dims)
    tolerance = int(max(min_rows, min_cols) * 0.05)
    if (max_rows - min_rows) > tolerance or (max_cols - min_cols) > tolerance:
        raise InvalidInput(
            f"Frame dimensions vary too much (rows: {max_rows - min_rows}px, "
            f"cols: {max_cols - min_cols}px, tolerance: {tolerance}px)")

    if device is None:
        first = images[0]
        device = first.device if isinstance(first, torch.Tensor) else \
            cuda_device()
    stack = torch.stack([
        torch.as_tensor(img)[:min_rows, :min_cols].to(device=device,
                                                      dtype=torch.float32)
        for img in images])
    n = stack.shape[0]
    scale = min(max(config.scale, 1.0), 4.0)
    pixfrac = min(max(config.pixfrac, 0.1), 1.0)
    out_rows = math.ceil(min_rows * scale)
    out_cols = math.ceil(min_cols * scale)

    offsets: List[Tuple[float, float]] = [(0.0, 0.0)]
    if config.align:
        by_pc = config.alignment_method == AlignmentMethod.PHASE_CORRELATION
        if by_pc:
            pc = phase_correlate_stack(stack[0], stack[1:])
            pc = torch.stack(pc).cpu().tolist()
        for i in range(1, n):
            if by_pc and not is_low_confidence(pc[2][i - 1]):
                dy, dx = pc[0][i - 1], pc[1][i - 1]
            else:   # low confidence, or AFFINE/ZNCC (drizzle.rs:302-306)
                dy, dx, _ = estimate_offset(stack[0], stack[i],
                                            AlignMethod.AFFINE)
            offsets.append((dx, dy))
            if progress is not None:
                progress.tick_with_stage(f"align {i}/{n - 1}")
                progress.check_cancelled()
    else:
        offsets += [(0.0, 0.0)] * (n - 1)

    d_xs = torch.tensor([-dx for dx, _dy in offsets], dtype=torch.float32,
                        device=device)
    d_ys = torch.tensor([-dy for _dx, dy in offsets], dtype=torch.float32,
                        device=device)
    if progress is not None:
        progress.tick_with_stage("drizzling")
    # auto-route (drizzle.py:753-766): with one contribution per frame
    # per output pixel the pre-averaging route is identical
    if (exact and config.kernel == DrizzleKernel.SQUARE
            and 1.0 + pixfrac * scale <= scale + 1e-9):
        exact = False
    args = (stack, d_ys, d_xs, scale, pixfrac, config.kernel, out_rows,
            out_cols, config.sigma_low, config.sigma_high,
            config.sigma_iterations)
    if exact:
        image, weight_map, rejected = _drizzle_kernel_exact(*args)
    else:
        image, weight_map, rejected = _drizzle_kernel(*args)
    return DrizzleResult(
        image=image, weight_map=weight_map, frame_count=n,
        output_scale=scale, input_dims=(min_rows, min_cols),
        output_dims=(out_rows, out_cols), offsets=offsets,
        rejected_pixels=int(rejected))
