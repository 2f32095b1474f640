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
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.ops.masking import validity_mask

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
    mn, mx, total, count, med, mad = torch.stack(
        [v.to(torch.float64) for v in stats_core(x, exact_pair)]).tolist()
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
