"""K9: the exact drizzle with its candidates gathered in the kernel.

Counterpart of astroburst_tpu/stacking/drizzle_gather_kernel.py:
``drizzle_gather_finalize_parity``; the CUDA kernel is
``csrc/drizzle_gather.cu`` (header note there: what bounds it and how it
is laid out). For an integer scale S, output pixel (oy, ox) =
(S·qy + py, S·qx + px) has candidate (f, t, u) =
stack[f, qy + sy[f, py] + t, qx + sx[f, px] + u] with weight
wy[oy, f·taps + t] · wx[f·taps + u, ox]; the capped push list of those
candidates is finalized as K7 finalizes it (``csrc/drizzle_finalize.cuh``
holds the one ``finalize_pixel`` of both). The shifts and weights come
from stacking/drizzle.py:_plan_parity.

The kernel writes the full [S·h, S·w] planes, interleaved in place. The
plain version builds each parity plane's candidates and runs K7's plain
version parity by parity (JAX's ``_parity_call``, drizzle.py:591-619,
which bounds its memory to one parity's candidates), then
``_interleave_parity``. A tap whose input index falls outside the plane
has weight 0 in both (the plan's weights carry it; both also refuse such
an index outright), so neither reads outside the stack and no padded
copy is made.

``drizzle_gather_banded`` is the same gather for any scale, from the
banded route's own per-row tap tables (``csrc/drizzle_banded.cu``):
output pixel (y, x) of the padded grid has candidate (f, t, u) =
stack[f, iy[y, f·taps + t], ix[f·taps + u, x]] with weight
wys_t[y, f·taps + t] · wxs[f·taps + u, x]. ``_drizzle_kernel_exact``
takes it for every band in one call
(stacking/drizzle.py:_drizzle_one_launch). Its plain version gathers
the candidates of ``PLAIN_ROWS`` rows at a time and runs K7's plain
version on them.

``drizzle_gather_finalize`` and ``drizzle_gather_banded`` launch the
kernel for a CUDA tensor and run the plain version for a CPU tensor;
they never fall back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking.drizzle import _gather, _interleave_parity
from astroburst_tpu_torch.stacking.drizzle_kernel import (
    MAX_CAP, _check_common, _outputs, drizzle_finalize_fused_plain)

PLAIN_ROWS = 64          # output rows a plain gather holds at once
SCRATCH_BYTES = 1 << 30  # the banded kernel's scratch a launch, past MAX_CAP


def _parity_taps(base: torch.Tensor, p: int, taps: int, n_in: int,
                 w_rows: torch.Tensor):
    """One axis of parity p: (index [n, taps, n_in] clamped into the
    plane, weight [n·taps, n_in] with out-of-plane taps at 0). ``base``
    [n, S] holds tap 0's index at q = 0, ``w_rows`` [n·taps, S·n_in] the
    full grid's weights."""
    n, s = base.shape
    idx = (base[:, p, None, None]
           + torch.arange(taps, device=base.device)[None, :, None]
           + torch.arange(n_in, device=base.device)[None, None, :])
    inside = ((idx >= 0) & (idx < n_in)).reshape(n * taps, n_in)
    w = torch.where(inside, w_rows[:, p::s], 0.0)
    return torch.clamp(idx, 0, n_in - 1), w


def drizzle_gather_finalize_plain(stack, base_y, base_x, wys_t, wxs,
                                  taps: int, cap: int, sigma_low: float,
                                  sigma_high: float, iterations: int):
    """K9 in torch: per parity plane, the candidates and K7's plain
    finalize; then the interleave. Returns (image f32, weight map f32,
    rejected map i32), each [S·h, S·w]."""
    n, h, w = stack.shape
    s = base_y.shape[1]
    base_y = base_y.to(torch.int64)
    base_x = base_x.to(torch.int64)
    wys = wys_t.T
    planes = []
    for pr in range(s):
        idy, wy = _parity_taps(base_y, pr, taps, h, wys)
        for pc in range(s):
            idx, wx = _parity_taps(base_x, pc, taps, w, wxs)
            planes.append(drizzle_finalize_fused_plain(
                _gather(stack, idy, idx), wy.T, wx, n, taps, taps, cap,
                sigma_low, sigma_high, iterations))
    return tuple(_interleave_parity(torch.stack([p[i] for p in planes]), s)
                 for i in range(3))


def drizzle_gather_finalize(stack, base_y, base_x, wys_t, wxs, taps: int,
                            cap: int, sigma_low: float, sigma_high: float,
                            iterations: int):
    """Gather and finalize the exact drizzle of ``stack`` [n, h, w] (raw
    values, NaN/inf kept) at integer scale S = base_y.shape[1]:
    ``base_y`` [n, S] / ``base_x`` [n, S] int32 tap-0 input indices per
    frame and parity, ``wys_t`` [S·h, n·taps] and ``wxs`` [n·taps, S·w]
    the tap weights. Returns (image f32, weight map f32, rejected map
    i32), each [S·h, S·w]."""
    if not K.use_kernel(stack, "drizzle_gather_finalize"):
        return drizzle_gather_finalize_plain(stack, base_y, base_x, wys_t,
                                             wxs, taps, cap, sigma_low,
                                             sigma_high, iterations)
    K.require_cuda(stack, "stack", 3)
    K.require_cuda(base_y, "base_y", 2, torch.int32)
    K.require_cuda(base_x, "base_x", 2, torch.int32)
    K.require_cuda(wys_t, "wys_t", 2)
    K.require_cuda(wxs, "wxs", 2)
    n, h, w = stack.shape
    s = base_y.shape[1]
    if s < 1 or taps < 1 or base_y.shape != (n, s) \
            or base_x.shape != (n, s) \
            or wys_t.shape != (s * h, n * taps) \
            or wxs.shape != (n * taps, s * w):
        raise ValueError(
            f"shapes do not match: stack {tuple(stack.shape)}, base_y "
            f"{tuple(base_y.shape)}, base_x {tuple(base_x.shape)}, wys_t "
            f"{tuple(wys_t.shape)}, wxs {tuple(wxs.shape)}, taps {taps}")
    _check_common(cap, iterations)
    scratch, img, wgt, rej = _outputs(n * taps * taps, s * h, s * w, cap,
                                      stack.device)
    K.launch("abt_drizzle_gather", stack.data_ptr(), base_y.data_ptr(),
             base_x.data_ptr(), wys_t.data_ptr(), wxs.data_ptr(), n, taps, s,
             h, w, cap, float(sigma_low), float(sigma_high), int(iterations),
             K.ptr(scratch), img.data_ptr(), wgt.data_ptr(), rej.data_ptr(),
             K.stream_handle(stack))
    drizzle_gather_finalize.launches += 1
    return img, wgt, rej


drizzle_gather_finalize.launches = 0


def _inside(idx: torch.Tensor, w: torch.Tensor, n_in: int):
    """(index clamped into [0, n_in), weight with out-of-plane taps at 0)."""
    inside = (idx >= 0) & (idx < n_in)
    return (torch.clamp(idx, 0, n_in - 1).to(torch.int64),
            torch.where(inside, w, 0.0))


def drizzle_gather_banded_plain(stack, iy, wys_t, ix, wxs, taps: int,
                                cap: int, sigma_low: float,
                                sigma_high: float, iterations: int):
    """``drizzle_gather_banded`` in torch: the candidates of
    ``PLAIN_ROWS`` output rows at a time (``_gather`` in push order),
    then K7's plain version. Returns (image f32, weight map f32, rejected
    map i32), each [h, w]."""
    n = stack.shape[0]
    h, w = wys_t.shape[0], wxs.shape[1]
    idx, wx = _inside(ix, wxs, stack.shape[2])
    idx = idx.reshape(n, taps, w)
    parts = []
    for r0 in range(0, h, PLAIN_ROWS):
        rows = min(PLAIN_ROWS, h - r0)
        idy, wy = _inside(iy[r0:r0 + rows], wys_t[r0:r0 + rows],
                          stack.shape[1])
        parts.append(drizzle_finalize_fused_plain(
            _gather(stack, idy.T.reshape(n, taps, rows), idx), wy, wx, n,
            taps, taps, cap, sigma_low, sigma_high, iterations))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def drizzle_gather_banded(stack, iy, wys_t, ix, wxs, taps: int, cap: int,
                          sigma_low: float, sigma_high: float,
                          iterations: int):
    """Gather and finalize the exact drizzle of ``stack`` [n, in_h, in_w]
    (raw values, NaN/inf kept) from per-row tap tables: ``iy`` [h,
    n·taps] int32 / ``wys_t`` [h, n·taps] f32, each output row's input
    row and weight of tap t of frame f at column f·taps + t; ``ix``
    [n·taps, w] int32 / ``wxs`` [n·taps, w] f32, the same of each output
    column. Returns (image f32, weight map f32, rejected map i32), each
    [h, w]. Past MAX_CAP live values the kernel runs over bands of rows
    whose scratch fits ``SCRATCH_BYTES``."""
    n = stack.shape[0] if stack.ndim == 3 else 0
    h = wys_t.shape[0] if wys_t.ndim == 2 else 0
    w = wxs.shape[1] if wxs.ndim == 2 else 0
    if stack.ndim != 3 or taps < 1 or iy.shape != (h, n * taps) \
            or wys_t.shape != (h, n * taps) or ix.shape != (n * taps, w) \
            or wxs.shape != (n * taps, w):
        raise ValueError(
            f"shapes do not match: stack {tuple(stack.shape)}, iy "
            f"{tuple(iy.shape)}, wys_t {tuple(wys_t.shape)}, ix "
            f"{tuple(ix.shape)}, wxs {tuple(wxs.shape)}, taps {taps}")
    _check_common(cap, iterations)
    if not K.use_kernel(stack, "drizzle_gather_banded"):
        return drizzle_gather_banded_plain(stack, iy, wys_t, ix, wxs, taps,
                                           cap, sigma_low, sigma_high,
                                           iterations)
    K.require_cuda(stack, "stack", 3)
    K.require_cuda(iy, "iy", 2, torch.int32)
    K.require_cuda(wys_t, "wys_t", 2)
    K.require_cuda(ix, "ix", 2, torch.int32)
    K.require_cuda(wxs, "wxs", 2)
    _, in_h, in_w = stack.shape
    depth = min(cap, n * taps * taps)
    img = torch.empty((h, w), dtype=torch.float32, device=stack.device)
    wgt = torch.empty_like(img)
    rej = torch.empty((h, w), dtype=torch.int32, device=stack.device)
    step = h if depth <= MAX_CAP else max(1, SCRATCH_BYTES // (4 * depth * w))
    scratch = None if depth <= MAX_CAP else torch.empty(
        (depth, min(step, h), w), dtype=torch.float32, device=stack.device)
    for y0 in range(0, h, step):
        rows = min(step, h - y0)
        K.launch("abt_drizzle_gather_banded", stack.data_ptr(),
                 iy[y0].data_ptr(), wys_t[y0].data_ptr(), ix.data_ptr(),
                 wxs.data_ptr(), n, taps, in_h, in_w, rows, w, cap,
                 float(sigma_low), float(sigma_high), int(iterations),
                 K.ptr(scratch), img[y0].data_ptr(), wgt[y0].data_ptr(),
                 rej[y0].data_ptr(), K.stream_handle(stack))
        drizzle_gather_banded.launches += 1
    return img, wgt, rej


drizzle_gather_banded.launches = 0
