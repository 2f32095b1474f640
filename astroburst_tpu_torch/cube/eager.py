"""In-memory IFU cube processing (counterpart of
astroburst_tpu/cube/eager.py).

Reference: src-tauri/src/core/cube/eager.rs — mean/median collapse,
per-pixel spectrum, spectral-axis classification from CTYPE3/CUNIT3,
linear wavelength axis, global asinh-normalize stats (1%/99.9%
percentile clamp, α = 10).

The collapses are plain torch, as they are XLA in the JAX package.
They run over chunks of pixel columns, so a 2 GiB cube needs no more
than a few hundred MB beside itself. ``collapse_median`` sorts each
column over the spectral axis (+inf fill) and reads index cnt // 2, as
the JAX package's sort + ``_rank_select`` does: bit-equal. The global
stats are exact order statistics (``ops/select.global_stats``), where
the JAX package uses its compare-count quantile (within range/8⁶,
ROADMAP C21). On a CUDA cube they are the radix select of
``csrc/radix_select.cu``: six histogram passes over the cube in place,
no sort and no copy of it (trace counter ``cube.stats.radix_select``).
On the CPU, and on the card inside ``kernels.plain_versions()``
(counter ``cube.stats.plain``), the plain version sorts the values a
16 M chunk at a time into one buffer the cube's size and bisects over
their keys; the two give the same bits. The classification and the
wavelength axis are host code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.select import global_stats
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace

SPECTRAL_CTYPES = ("WAVE", "FREQ", "VELO", "AWAV", "VRAD", "VOPT", "ZOPT",
                   "BETA", "ENER")
SPECTRAL_UNITS = ("M", "CM", "MM", "UM", "NM", "ANGSTROM", "A", "HZ", "KHZ",
                  "MHZ", "GHZ", "M/S", "KM/S", "EV", "KEV")

CHUNK_ELEMENTS = 1 << 25   # elements of one column chunk (128 MB of f32)


def _column_chunks(cube: torch.Tensor):
    """(p0, p1, [C, p1 - p0] view) over the flattened pixel axis."""
    depth = cube.shape[0]
    flat = cube.reshape(depth, -1)
    step = max(CHUNK_ELEMENTS // max(depth, 1), 1)
    for p0 in range(0, flat.shape[1], step):
        p1 = min(p0 + step, flat.shape[1])
        yield p0, p1, flat[:, p0:p1]


def collapse_mean(cube: torch.Tensor) -> torch.Tensor:
    """Masked f32 mean over the spectral axis (finite values)."""
    out = torch.empty(cube.shape[1] * cube.shape[2], dtype=torch.float32,
                      device=cube.device)
    for p0, p1, x in _column_chunks(cube):
        finite = torch.isfinite(x)
        cnt = finite.sum(dim=0, dtype=torch.float32)
        s = torch.where(finite, x, 0.0).sum(dim=0)
        out[p0:p1] = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    return out.reshape(cube.shape[1:])


def collapse_median(cube: torch.Tensor) -> torch.Tensor:
    """Per-pixel median of the finite non-zero values: sorted index
    cnt // 2, 0 where there is none (eager.rs:28-55, select_nth)."""
    depth = cube.shape[0]
    out = torch.empty(cube.shape[1] * cube.shape[2], dtype=torch.float32,
                      device=cube.device)
    for p0, p1, x in _column_chunks(cube):
        xt = x.T
        ok = torch.isfinite(xt) & (xt != 0.0)
        cnt = ok.sum(dim=1)
        svals = torch.sort(torch.where(ok, xt, float("inf")), dim=1).values
        idx = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"),
                          max=depth - 1)
        med = torch.gather(svals, 1, idx[:, None])[:, 0]
        out[p0:p1] = torch.where(cnt > 0, med, 0.0)
    return out.reshape(cube.shape[1:])


@dataclass
class SpectralClassification:
    is_spectral: bool
    reason: str
    axis_type: Optional[str]
    axis_unit: Optional[str]
    channel_count: int

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def classify_spectral_cube(header: HduHeader,
                           naxis3: int) -> SpectralClassification:
    """eager.rs:71-145 decision chain."""
    def norm(key):
        v = header.get(key)
        return v.strip().strip("'").strip().upper() if v else None

    ctype3 = norm("CTYPE3")
    cunit3 = norm("CUNIT3")
    has_cdelt3 = header.get_f64("CDELT3") is not None
    has_crval3 = header.get_f64("CRVAL3") is not None

    ctype_spectral = ctype3 is not None and any(
        s in ctype3 for s in SPECTRAL_CTYPES)
    cunit_spectral = cunit3 is not None and any(
        cunit3 == s or s in cunit3 for s in SPECTRAL_UNITS)

    if ctype_spectral:
        return SpectralClassification(
            True, f"CTYPE3 indicates spectral axis: {ctype3}", ctype3,
            cunit3, naxis3)
    if cunit_spectral and has_cdelt3:
        return SpectralClassification(
            True, f"CUNIT3 indicates spectral data: {cunit3}", ctype3,
            cunit3, naxis3)
    if naxis3 <= 4:
        return SpectralClassification(
            False, f"NAXIS3={naxis3} with no spectral keywords: likely "
            f"RGB/RGBA composition", ctype3, cunit3, naxis3)
    if has_cdelt3 and has_crval3:
        return SpectralClassification(
            True, f"NAXIS3={naxis3} with CRVAL3/CDELT3 present: likely "
            f"spectral cube", ctype3, cunit3, naxis3)
    if naxis3 > 10:
        return SpectralClassification(
            True, f"NAXIS3={naxis3}: high channel count suggests spectral "
            f"data", ctype3, cunit3, naxis3)
    return SpectralClassification(
        False, f"NAXIS3={naxis3} with no spectral metadata: ambiguous, "
        f"treating as non-spectral", ctype3, cunit3, naxis3)


def build_wavelength_axis(header: HduHeader) -> Optional[List[float]]:
    """Linear axis from CRVAL3/CDELT3/CRPIX3 (eager.rs:147-159)."""
    crval3 = header.get_f64("CRVAL3")
    cdelt3 = header.get_f64("CDELT3")
    naxis3 = header.get_i64("NAXIS3")
    if crval3 is None or cdelt3 is None or naxis3 is None:
        return None
    crpix3 = header.get_f64("CRPIX3") or 1.0
    return [crval3 + (i - crpix3 + 1.0) * cdelt3 for i in range(naxis3)]


@dataclass
class GlobalCubeStats:
    median: float
    sigma: float
    low: float
    high: float


def compute_global_stats(cube: torch.Tensor) -> GlobalCubeStats:
    """Median, MAD-sigma and the 1% / 99.9% values of the finite
    non-zero values of ``cube`` (any shape), exactly, with one fetch
    (eager.rs:185-205). On a CUDA cube counts trace counter
    ``cube.stats.radix_select`` (the kernel ran) or ``cube.stats.plain``
    (inside ``kernels.plain_versions()``)."""
    flat = cube.reshape(-1)
    if flat.is_cuda:
        trace.count("cube.stats.radix_select"
                    if K.use_kernel(flat, "global_stats")
                    else "cube.stats.plain", 1)
    cnt, med, mad, low, high = global_stats(flat).tolist()
    if int(cnt) == 0:
        return GlobalCubeStats(0.0, 1.0, 0.0, 1.0)
    return GlobalCubeStats(median=med,
                           sigma=max(mad * MAD_TO_SIGMA, 1e-10),
                           low=low, high=high)


def normalize_with_global(data: torch.Tensor,
                          g: GlobalCubeStats) -> torch.Tensor:
    """asinh preview normalize (eager.rs:210-222): the values clamped
    to [low, high], asinh(α (v − median) / σ) with α = 10, non-finite →
    0."""
    median, sigma, low, high = torch.tensor(
        [g.median, g.sigma, g.low, g.high],
        dtype=torch.float32).to(data.device).unbind()
    clamped = torch.minimum(torch.maximum(data, low), high)
    scaled = (10.0 / sigma) * (clamped - median)
    return torch.where(torch.isfinite(data), torch.asinh(scaled), 0.0)
