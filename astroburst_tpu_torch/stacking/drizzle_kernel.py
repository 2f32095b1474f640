"""K7 and K8: the exact drizzle's per-pixel finalize.

Counterparts of astroburst_tpu/stacking/drizzle_kernel.py:
``drizzle_finalize_fused`` (K7: raw candidate values plus per-axis tap
weights, w = wy·wx and finiteness formed in the kernel) and
``drizzle_finalize_pallas`` (K8, here ``drizzle_finalize``: values and
materialized weights). Both are one CUDA source,
``csrc/drizzle_finalize.cu`` (header note there: what bounds it and how
it is laid out): capped push list → iterative median/MAD clip → mean of
the survivors, Σw and the rejected count per output pixel.

The plain versions are stacking/drizzle.py:_finalize_exact, with
presence = isfinite(v) & (w > 1e-12) for K7 and w > 1e-12 for K8 (K8
takes the candidates as the JAX ``_frame_candidates`` makes them: a value
whose weight passes the threshold is finite). The kernel keeps at most
``min(cap, m)`` live values per pixel: in registers up to 32, in a
column of shared memory up to ``MAX_CAP``; above it (more than 128
frames at cap = 2n) the wrappers allocate a global scratch
[min(cap, m), H, W] for the kernel's pixel-minor instance, which is
slower. Every instance is bit-equal to the plain version. The TPU
kernels' block-divisibility constraint does not exist here.

``drizzle_finalize_fused`` and ``drizzle_finalize`` launch the kernel
for a CUDA tensor and run the plain version for a CPU tensor; they
never fall back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking.drizzle import _finalize_exact, _outer

MAX_CAP = 256  # deepest shared-memory column (csrc/drizzle_finalize.cu)


def drizzle_finalize_fused_plain(cand_v_raw, wys_t, wxs, n: int, taps_y: int,
                                 taps_x: int, cap: int, sigma_low: float,
                                 sigma_high: float, iterations: int):
    """K7 in torch: w = wy·wx per candidate, presence = finite & w >
    1e-12, then ``_finalize_exact``."""
    m, h, w = cand_v_raw.shape
    weights = _outer(wys_t.T.reshape(n, taps_y, h),
                     wxs.reshape(n, taps_x, w))
    weights = torch.where(torch.isfinite(cand_v_raw), weights, 0.0)
    return _finalize_exact(cand_v_raw, weights, cap, sigma_low, sigma_high,
                           iterations)


def drizzle_finalize_plain(cand_v, cand_w, cap: int, sigma_low: float,
                           sigma_high: float, iterations: int):
    """K8 in torch: ``_finalize_exact`` (presence = w > 1e-12)."""
    return _finalize_exact(cand_v, cand_w, cap, sigma_low, sigma_high,
                           iterations)


def _check_common(cap: int, iterations: int) -> None:
    if cap < 1 or iterations < 0:
        raise ValueError(f"cap must be >= 1 and iterations >= 0, got cap "
                         f"{cap}, iterations {iterations}")


def _outputs(m: int, h: int, w: int, cap: int, device):
    """(scratch or None, image, weight map, rejected map): the scratch
    [min(cap, m), h, w] only where the live values outgrow MAX_CAP."""
    depth = min(cap, m)
    scratch = torch.empty((depth, h, w), dtype=torch.float32,
                          device=device) if depth > MAX_CAP else None
    return (scratch,
            torch.empty((h, w), dtype=torch.float32, device=device),
            torch.empty((h, w), dtype=torch.float32, device=device),
            torch.empty((h, w), dtype=torch.int32, device=device))


def drizzle_finalize_fused(cand_v_raw, wys_t, wxs, n: int, taps_y: int,
                           taps_x: int, cap: int, sigma_low: float,
                           sigma_high: float, iterations: int):
    """Finalize [n·taps_y·taps_x, H, W] RAW candidate values (NaN/inf
    kept) with tap weights wys_t [H, n·taps_y] (transposed, as the JAX
    kernel takes them) and wxs [n·taps_x, W]. Returns (image f32,
    weight_map f32, rejected map i32), each [H, W]."""
    if not K.use_kernel(cand_v_raw, "drizzle_finalize_fused"):
        return drizzle_finalize_fused_plain(cand_v_raw, wys_t, wxs, n,
                                            taps_y, taps_x, cap, sigma_low,
                                            sigma_high, iterations)
    K.require_cuda(cand_v_raw, "cand_v_raw", 3)
    K.require_cuda(wys_t, "wys_t", 2)
    K.require_cuda(wxs, "wxs", 2)
    m, h, w = cand_v_raw.shape
    if m != n * taps_y * taps_x or wys_t.shape != (h, n * taps_y) \
            or wxs.shape != (n * taps_x, w):
        raise ValueError(
            f"shapes do not match: cand_v_raw {tuple(cand_v_raw.shape)}, "
            f"wys_t {tuple(wys_t.shape)}, wxs {tuple(wxs.shape)} for n={n}, "
            f"taps ({taps_y}, {taps_x})")
    _check_common(cap, iterations)
    scratch, img, wgt, rej = _outputs(m, h, w, cap, cand_v_raw.device)
    K.launch("abt_drizzle_finalize_fused", cand_v_raw.data_ptr(),
             wys_t.data_ptr(), wxs.data_ptr(), n, taps_y, taps_x, h, w, cap,
             float(sigma_low), float(sigma_high), int(iterations),
             K.ptr(scratch), img.data_ptr(), wgt.data_ptr(), rej.data_ptr(),
             K.stream_handle(cand_v_raw))
    drizzle_finalize_fused.launches += 1
    return img, wgt, rej


def drizzle_finalize(cand_v, cand_w, cap: int, sigma_low: float,
                     sigma_high: float, iterations: int):
    """Finalize [m, H, W] ordered candidates (values, materialized
    weights). Returns (image f32, weight_map f32, rejected map i32)."""
    if not K.use_kernel(cand_v, "drizzle_finalize"):
        return drizzle_finalize_plain(cand_v, cand_w, cap, sigma_low,
                                      sigma_high, iterations)
    K.require_cuda(cand_v, "cand_v", 3)
    K.require_cuda(cand_w, "cand_w", 3)
    if cand_w.shape != cand_v.shape:
        raise ValueError(f"cand_w {tuple(cand_w.shape)} differs from "
                         f"cand_v {tuple(cand_v.shape)}")
    m, h, w = cand_v.shape
    _check_common(cap, iterations)
    scratch, img, wgt, rej = _outputs(m, h, w, cap, cand_v.device)
    K.launch("abt_drizzle_finalize", cand_v.data_ptr(), cand_w.data_ptr(),
             m, h, w, cap, float(sigma_low), float(sigma_high),
             int(iterations), K.ptr(scratch), img.data_ptr(), wgt.data_ptr(),
             rej.data_ptr(), K.stream_handle(cand_v))
    drizzle_finalize.launches += 1
    return img, wgt, rej


drizzle_finalize_fused.launches = 0
drizzle_finalize.launches = 0
