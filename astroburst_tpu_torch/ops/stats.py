"""Robust image statistics (counterpart of astroburst_tpu/ops/stats.py).

Median and MAD are exact order statistics taken from ``torch.sort``
(invalid pixels sort to the end as +inf), at the ranks of
astroburst_tpu/ops/quantile.py:125-154:

- ``exact_pair=False`` (the histogram path, stats.rs:100): the single
  1-based rank ceil(n/2);
- ``exact_pair=True`` (median.rs:27-43): the mean of ranks
  floor((n+1)/2) and floor(n/2)+1.

The JAX package's compare-count refinement (ops/quantile.py) and sort
networks (ops/sort_network.py) exist only for the TPU and are not
ported; the JAX value lies within range/8**6 (~4e-6 relative) of the
exact one. The ranks are read with device-side indexing, so
``stats_core`` never waits on the host; ``compute_image_stats`` fetches
its six results in one transfer.

Histograms (stats.rs:355-444) are the direct form: each valid pixel's
bin is found by ``torch.searchsorted`` over the f32 interior edges and
counted by ``torch.bincount`` in int64, as the reference counts in
usize. The JAX package counts below each edge in f32 (its compare-count
form for the TPU), so its counts stop being exact past 2**24 valid
pixels; the port's stay exact (ROADMAP C15).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from astroburst_tpu_torch.constants import (HISTOGRAM_BINS_DISPLAY,
                                            MAD_TO_SIGMA)
from astroburst_tpu_torch.dtypes import Histogram, ImageStats
from astroburst_tpu_torch.ops.masking import validity_mask
from astroburst_tpu_torch.runtime import trace

EXACT_PATH_MAX_PIXELS = 4_000_000  # stats.rs:18


def _rank_median(sorted_vals: torch.Tensor, count: torch.Tensor,
                 exact_pair: bool) -> torch.Tensor:
    """Median of the first ``count`` entries of an ascending 1-D tensor
    (0 when count is 0)."""
    if exact_pair:
        r1 = torch.div(count + 1, 2, rounding_mode="floor")
        r2 = torch.div(count, 2, rounding_mode="floor") + 1
        v1 = sorted_vals[torch.clamp(r1 - 1, min=0)]
        v2 = sorted_vals[torch.clamp(r2 - 1, min=0)]
        med = (v1 + v2) * 0.5
    else:
        r = torch.div(count + 1, 2, rounding_mode="floor")  # ceil(n/2)
        med = sorted_vals[torch.clamp(r - 1, min=0)]
    return torch.where(count > 0, med, torch.zeros_like(med))


def stats_core(x: torch.Tensor, exact_pair: bool):
    """(min, max, sum, count, median, mad) of the valid pixels of x
    (any shape), as 0-d tensors on x's device."""
    with trace.span("stats.core"):
        return _stats_core(x, exact_pair)


def _stats_core(x: torch.Tensor, exact_pair: bool):
    flat = x.reshape(-1)
    mask = validity_mask(flat)
    count = mask.sum()
    total = torch.where(mask, flat, torch.zeros_like(flat)).sum()
    inf = torch.full_like(flat, float("inf"))
    xm = torch.where(mask, flat, inf)
    mn = xm.min()
    mx = torch.where(mask, flat, -inf).max()
    med = _rank_median(torch.sort(xm).values, count, exact_pair)
    dev = torch.where(mask, torch.abs(flat - med), inf)
    mad = _rank_median(torch.sort(dev).values, count, exact_pair)
    return mn, mx, total, count, med, mad


def compute_image_stats(x: torch.Tensor) -> ImageStats:
    """NaN-safe robust stats of a tensor (any shape): the exact
    even-averaging median up to 4 M pixels, the single-rank one above,
    as the reference switches (stats.rs:18). The six values reach the
    host in one transfer (as f64: exact for the f32 values and the
    count)."""
    exact_pair = x.numel() <= EXACT_PATH_MAX_PIXELS
    with trace.span("stats.core"):
        mn, mx, total, count, med, mad = torch.stack(
            [v.to(torch.float64) for v in _stats_core(x, exact_pair)]
        ).tolist()
    n = int(count)
    if n == 0:
        return ImageStats()
    return ImageStats(
        min=mn,
        max=mx,
        mean=total / n,
        median=med,
        mad=mad,
        sigma=max(mad * MAD_TO_SIGMA, 1e-30),
        valid_count=n,
    )


def _stats_minmax(x: torch.Tensor):
    """(min, max) of the valid pixels as 0-d tensors (+inf, -inf when
    there are none)."""
    flat = x.reshape(-1)
    mask = validity_mask(flat)
    inf = torch.full_like(flat, float("inf"))
    return torch.where(mask, flat, inf).min(), \
        torch.where(mask, flat, -inf).max()


def valid_range(x: torch.Tensor):
    """(min, max) of the valid pixels as host floats, (0, 0) where none
    is valid: ``compute_image_stats``'s min and max, one fetch, no
    sort."""
    mn, mx = torch.stack(_stats_minmax(x)).tolist()
    return (mn, mx) if mn <= mx else (0.0, 0.0)


def select_half(values: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The reference's select_nth(len/2): the element at sorted index
    count // 2 of a 1-D tensor whose ``count`` valid entries are finite
    and whose others are +inf, exactly, as a 0-d tensor on its device (0
    when count is 0). The index is read on the device: no host wait."""
    idx = torch.clamp(torch.div(count, 2, rounding_mode="floor"),
                      max=values.numel() - 1)
    val = torch.sort(values).values[idx]
    return torch.where(count > 0, val, 0.0)


def histogram_counts(x: torch.Tensor, dmin: float, dmax: float,
                     bins: int) -> torch.Tensor:
    """int64 [bins] counts of the valid pixels of x. Bin j counts
    e_j <= v < e_{j+1} over the f32 interior edges e_j = dmin + step·j
    (j = 1 .. bins-1, step = (dmax - dmin) / bins, each operation
    rounded to f32, as astroburst_tpu/ops/stats.py:88-101 forms them):
    values below dmin go to bin 0, values at or above the last interior
    edge (v == dmax included) to the last bin (the reference's
    truncating index, stats.rs:393-403)."""
    flat = x.reshape(-1)
    lo = torch.tensor(dmin, dtype=torch.float32, device=x.device)
    step = (torch.tensor(dmax, dtype=torch.float32, device=x.device)
            - lo) / bins
    edges = lo + step * torch.arange(1, bins, dtype=torch.float32,
                                     device=x.device)
    idx = torch.searchsorted(edges, flat, right=True, out_int32=True)
    # invalid pixels go to an extra bin past the last, dropped below
    idx = torch.where(validity_mask(flat), idx, bins)
    return torch.bincount(idx, minlength=bins + 1)[:bins]


def compute_histogram(x: torch.Tensor, bins: int,
                      dmin: Optional[float] = None,
                      dmax: Optional[float] = None) -> Histogram:
    """Histogram over the valid range (stats.rs:355-421). The returned
    ``bin_edges`` are the JAX package's host list in f64 (dmin + i ·
    step), not the f32 edges the counts were taken at."""
    if dmin is None or dmax is None:
        mn, mx = torch.stack(_stats_minmax(x)).tolist()
        dmin = mn if dmin is None else dmin
        dmax = mx if dmax is None else dmax
    if not math.isfinite(dmin) or not math.isfinite(dmax) \
            or (dmax - dmin) < 1e-10:
        return Histogram(bins=[0] * bins, bin_edges=[dmin] * (bins + 1),
                         min=dmin, max=dmax)
    counts = histogram_counts(x, dmin, dmax, bins).tolist()
    step = (dmax - dmin) / bins
    edges = [dmin + i * step for i in range(bins + 1)]
    return Histogram(bins=counts, bin_edges=edges, min=dmin, max=dmax)


def compute_histogram_with_stats(x: torch.Tensor, stats: ImageStats,
                                 bins: int = HISTOGRAM_BINS_DISPLAY
                                 ) -> Histogram:
    return compute_histogram(x, bins, dmin=stats.min, dmax=stats.max)


def downsample_histogram(hist: Histogram, target_bins: int) -> list:
    """Sum-pool bins down to target_bins (stats.rs:423-444)."""
    src = hist.bins
    if target_bins >= len(src):
        return list(src)
    ratio = len(src) / target_bins
    out = []
    for i in range(target_bins):
        start = int(i * ratio)
        end = min(int((i + 1) * ratio), len(src))
        out.append(int(sum(src[start:end])))
    return out
