"""Star detection (counterpart of astroburst_tpu/analysis/star_detection.py).

Reference: src-tauri/src/core/analysis/star_detection.rs — tile-based
sigma-clipped background, threshold at bg + σ·k, 8-connected flood-fill
components of 3..5000 px, flux-weighted centroid, second-moment
FWHM = 2.3548·σ, eigenvalue eccentricity, SNR = peak/bg_σ,
brightest-first 3 px dedup.

The JAX package's design is kept, on torch tensors:

1. background: the plane is cut into step × step tiles, each tile is
   sorted (kernel K10, analysis/tile_sort_kernel.py, for every step)
   and sigma-clipped as a contiguous interval of its sorted values; the
   median and the MAD are exact rank selections, the MAD's by JAX's
   two-run partition search over per-tile gathers (no sort);
2. peaks: 3 × 3 local maxima above the threshold with the JAX tie rule,
   reduced to one candidate per 2 × 2 block, then the top ``max_peaks``
   by a stable descending sort (value first, then flat index: the order
   ``jax.lax.top_k`` gives; its two-level form is a TPU device that
   selects the same set). With ``max_peaks=None`` the capacity follows
   the data: the candidates are counted on the device, fetched once and
   rounded up to a multiple of ``PEAK_BUCKET`` (``peak_capacity``), so
   every candidate is kept (the reference caps nothing; ROADMAP C49);
3. per-peak window statistics (kernel K11, analysis/window_kernel.py);
4. host-side brightest-first 3 px dedup of one fetched [10, max_peaks]
   array (``_postprocess_packed``, numpy, a copy of the JAX function),
   or, for the masked stretch, ``dedupe_packed_device``: the same accept
   set with the packed array left on the device, at any capacity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from astroburst_tpu_torch.analysis.tile_sort_kernel import sort_tiles
from astroburst_tpu_torch.analysis.window_kernel import (  # noqa: F401
    HALF, WINDOW, window_stats)
from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.runtime.device import as_f32

FWHM_FACTOR = 2.3548200450309493
MAX_PEAKS = 1024
PEAK_BUCKET = 1024     # data-driven capacities are multiples of this
DEDUPE_PX = 3.0        # the dedupe's radius (star_detection.rs:215)


@dataclass
class DetectedStar:
    x: float
    y: float
    flux: float
    fwhm: float
    eccentricity: float
    peak: float
    npix: int
    snr: float

    def to_dict(self) -> dict:
        return {"x": self.x, "y": self.y, "flux": self.flux,
                "fwhm": self.fwhm, "eccentricity": self.eccentricity,
                "peak": self.peak, "npix": self.npix, "snr": self.snr}


@dataclass
class DetectionResult:
    stars: List[DetectedStar]
    background_median: float
    background_sigma: float
    threshold_sigma: float
    image_width: int
    image_height: int


# --- tile background ---------------------------------------------------------


def _floordiv2(x: torch.Tensor) -> torch.Tensor:
    return torch.div(x, 2, rounding_mode="floor")


def _at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[t, idx[t]], the index clamped into the row."""
    idx = torch.clamp(idx, 0, rows.shape[1] - 1)
    return torch.gather(rows, 1, idx[:, None])[:, 0]


def _interval_median(sorted_rows, lo, hi):
    """Median of sorted_rows[t, lo[t]:hi[t]] with even-count averaging
    (math/median.rs:27-43); 0 for an empty interval."""
    cnt = hi - lo
    v1 = _at(sorted_rows, lo + torch.clamp(_floordiv2(cnt - 1), min=0))
    v2 = _at(sorted_rows, lo + torch.clamp(_floordiv2(cnt), min=0))
    return torch.where(cnt > 0, (v1 + v2) * 0.5, 0.0)


PROBES = 256   # partition probes a round of _sel_deviation_ranks


def _probe_rounds(p: int) -> int:
    """Rounds of PROBES probes that narrow a partition range of up to
    ``p`` to one point: each leaves at most ceil(span / PROBES) − 1."""
    rounds = 0
    while p > 0:
        p = -(-p // PROBES) - 1
        rounds += 1
    return rounds


def _sel_deviation_ranks(sorted_rows, med, lo, split, hi, ks):
    """Exact 0-based rank-k elements of the deviation multiset
    {|sorted_rows[t, i] − med[t]| : lo ≤ i < hi}, for [T, R] ranks
    ``ks`` (the JAX package's ``_sel_deviation_ranks``,
    astroburst_tpu/analysis/star_detection.py:84).

    The deviations form two ascending runs, A[i] = med − row[split−1−i]
    (the values below med, walking down) and B[j] = row[split+j] − med;
    in f32, med − x equals |x − med|, so this is the multiset's own
    values. The k-th smallest takes a from A and m − a from B (m = k +
    1), for the largest a in [max(m − lb, 0), min(m, la)] with
    A[a−1] ≤ B[m−a], a predicate that holds up to that a and fails
    after it. JAX bisects it in 18 rounds of one probe; here each round
    tests PROBES evenly spaced a at once (one gather of [T, R, PROBES]
    rows) and keeps the gap after the last that holds, so 2 rounds
    cover a 256² tile: the same partition, with ~25 small launches
    where bisection takes ~400."""
    t, p = sorted_rows.shape
    med = med[:, None, None]
    m = ks + 1
    a_lo = torch.clamp(m - (hi - split)[:, None], min=0)
    a_hi = torch.minimum(m, (split - lo)[:, None])
    j = torch.arange(1, PROBES + 1, device=sorted_rows.device)
    for _ in range(_probe_rounds(p)):
        step = torch.clamp(-torch.div(a_lo - a_hi, PROBES,
                                      rounding_mode="floor"), min=1)
        a = a_lo[..., None] + j * step[..., None]            # [T, R, K]
        below = split[:, None, None] - a                     # A[a − 1]
        above = below + m[..., None]                         # B[m − a]
        rows = torch.gather(sorted_rows, 1, torch.clamp(
            torch.cat([below, above], dim=1).reshape(t, -1), 0, p - 1))
        ra, rb = rows.reshape(t, 2, *a.shape[1:]).unbind(1)
        holds = (a <= a_hi[..., None]) & ((med - ra) <= (rb - med))
        a_lo = a_lo + holds.sum(dim=-1) * step
        a_hi = torch.minimum(a_lo + step - 1, a_hi)
    ia = split[:, None] - a_lo                               # A[a − 1]
    ib = split[:, None] + m - a_lo - 1                       # B[m − a − 1]
    rows = torch.gather(sorted_rows, 1, torch.clamp(
        torch.cat([ia, ib], dim=1), 0, p - 1))
    va = torch.where(a_lo > 0, med[:, :, 0] - rows[:, :ks.shape[1]],
                     float("-inf"))
    vb = torch.where(m - a_lo > 0, rows[:, ks.shape[1]:] - med[:, :, 0],
                     float("-inf"))
    return torch.maximum(va, vb)


def _interval_mad(sorted_rows, lo, hi, med):
    """Exact median absolute deviation of sorted_rows[t, lo:hi] with
    even-count averaging (the JAX package's ``_interval_mad``): the
    split below med by a binary search of the sorted rows (the count of
    window values below med), then both middle ranks of the deviations
    by ``_sel_deviation_ranks``. Nothing is sorted."""
    cnt = hi - lo
    below = torch.searchsorted(sorted_rows, med[:, None].contiguous())[:, 0]
    split = torch.minimum(torch.maximum(below, lo), hi)
    n = torch.clamp(cnt, min=1)
    ks = torch.stack([_floordiv2(n - 1), _floordiv2(n)], dim=1)
    vv = _sel_deviation_ranks(sorted_rows, med, lo, split, hi, ks)
    return torch.where(cnt > 0, (vv[:, 0] + vv[:, 1]) * 0.5, 0.0)


def _tile_sigma_clipped(sorted_rows, valid_counts, kappa: float = 3.0,
                        iterations: int = 2):
    """Vectorized sigma_clipped_stats (math/sigma_clip.rs:4-34) over
    pre-sorted tile rows; the retained set stays a contiguous interval."""
    lo = torch.zeros_like(valid_counts, dtype=torch.int64)
    hi = valid_counts.to(torch.int64)
    for _ in range(iterations):
        active = (hi - lo) >= 3
        med = _interval_median(sorted_rows, lo, hi)
        mad = _interval_mad(sorted_rows, lo, hi, med)
        sig = torch.clamp(mad * MAD_TO_SIGMA, min=1e-30)
        vlo = (med - kappa * sig)[:, None]
        vhi = (med + kappa * sig)[:, None]
        new_lo = (sorted_rows < vlo).sum(dim=1)
        new_hi = (sorted_rows <= vhi).sum(dim=1)
        lo = torch.where(active, torch.maximum(new_lo, lo), lo)
        hi = torch.where(active, torch.minimum(new_hi, hi), hi)
    empty = hi <= lo
    med = _interval_median(sorted_rows, lo, hi)
    mad = _interval_mad(sorted_rows, lo, hi, med)
    sig = torch.clamp(mad * MAD_TO_SIGMA, min=1e-30)
    return torch.where(empty, 0.0, med), torch.where(empty, 1.0, sig)


def _background(image: torch.Tensor, tile_size: int):
    """(median, sigma) of the background as 0-d f32 tensors on the
    image's device (star_detection.py:_estimate_background_kernel)."""
    rows, cols = image.shape
    step = max(tile_size, 16)
    ty = -(-rows // step)
    tx = -(-cols // step)
    padded = torch.nn.functional.pad(
        image, (0, tx * step - cols, 0, ty * step - rows), value=float("nan"))
    sorted_rows, counts = sort_tiles(padded, step)
    med, sig = _tile_sigma_clipped(sorted_rows, counts)
    # tiles with < 8 valid pixels are excluded (star_detection.rs:60)
    ok = counts >= 8
    mid = torch.clamp(_floordiv2(ok.sum()), max=ok.numel() - 1)
    # torch.take: indexing by a 0-d tensor would fetch the index to the host
    g_med = torch.take(torch.sort(torch.where(ok, med, float("inf"))).values,
                       mid)
    g_sig = torch.take(torch.sort(torch.where(ok, sig, float("inf"))).values,
                       mid)
    none = ~ok.any()
    return (torch.where(none, 0.0, g_med),
            torch.where(none, 1.0, torch.clamp(g_sig, min=1e-10)))


def _tile_size(rows: int, cols: int) -> int:
    return min(max(min(rows, cols) // 8, 32), 256)


def estimate_background(image, tile_size: int,
                        device: Optional[torch.device] = None):
    """(median, sigma) of the tile background, as Python floats."""
    med, sig = _background(as_f32(image, device), tile_size)
    return float(med), float(sig)


# --- peak detection + windowed moments ---------------------------------------


def _local_maxima(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask & (img ≥ all 8 neighbours, strictly > those at (dy, dx) >
    (0, 0)); the 1-px border is never a peak (star_detection.py:225-252)."""
    rows, cols = img.shape
    p = torch.nn.functional.pad(img, (1, 1, 1, 1), value=float("-inf"))
    strict = torch.ones_like(mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = p[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            if (dy, dx) > (0, 0):
                strict = strict & (img > shifted)
            else:
                strict = strict & (img >= shifted)
    strict[0, :] = False
    strict[-1, :] = False
    strict[:, 0] = False
    strict[:, -1] = False
    return mask & strict


def peak_capacity(n: int) -> int:
    """The capacity that holds ``n`` candidates: ``n`` rounded up to a
    multiple of PEAK_BUCKET (at least one bucket), so that a plane's
    shapes repeat from call to call."""
    return max(1, -(-int(n) // PEAK_BUCKET)) * PEAK_BUCKET


def _peaks(image: torch.Tensor, threshold: torch.Tensor,
           max_peaks: Optional[int]):
    """Peak selection of star_detection.py:261-333: (py, px i32 [K],
    values [K] f32 with -inf on dead slots, n_valid 0-d i32). K is
    ``max_peaks``, or with None ``peak_capacity`` of the candidates
    (one host fetch of their count)."""
    rows, cols = image.shape
    dev = image.device
    finite = torch.isfinite(image)
    above = finite & (image > threshold)
    peaks = _local_maxima(torch.where(finite, image, float("-inf")), above)
    score = torch.where(peaks, image, float("-inf"))
    # one candidate per 2×2 block: the tie rule above keeps 8-adjacent
    # cells from both being peaks
    r2 = -(-rows // 2) * 2
    c2 = -(-cols // 2) * 2
    sp = torch.nn.functional.pad(score, (0, c2 - cols, 0, r2 - rows),
                                 value=float("-inf"))
    cols_b = c2 // 2
    bmax = sp.reshape(r2 // 2, 2, cols_b, 2).amax(dim=(1, 3)).reshape(-1)
    if max_peaks is None:
        max_peaks = peak_capacity(torch.isfinite(bmax).sum())
    k_flat = min(max_peaks, bmax.numel())
    # jax.lax.top_k order: descending values, lower index first on ties
    vals, bidx = torch.sort(bmax, descending=True, stable=True)
    vals, bidx = vals[:k_flat], bidx[:k_flat]
    if k_flat < max_peaks:
        vals = torch.cat([vals, torch.full((max_peaks - k_flat,),
                                           float("-inf"), device=dev)])
        bidx = torch.cat([bidx, torch.zeros(max_peaks - k_flat,
                                            dtype=bidx.dtype, device=dev)])
    by = torch.div(bidx, cols_b, rounding_mode="floor")
    bx = bidx - by * cols_b
    flat = sp.reshape(-1)
    base = 2 * by * c2 + 2 * bx
    # row-major first match inside the block (top_k's index order)
    off = torch.where(flat[base] == vals, 0,
                      torch.where(flat[base + 1] == vals, 1,
                                  torch.where(flat[base + c2] == vals, c2,
                                              c2 + 1)))
    idx = base + off
    py = torch.div(idx, c2, rounding_mode="floor")
    px = idx - py * c2
    n_valid = torch.isfinite(vals).sum(dtype=torch.int32)
    return py.to(torch.int32), px.to(torch.int32), vals, n_valid


def _detect(image: torch.Tensor, tile_size: int, sigma_threshold: float,
            max_peaks: Optional[int]) -> torch.Tensor:
    """Background, peaks, window statistics and the packed [10, K] f32
    record (star_detection.py:_detect_fused): rows cy, cx, flux, fwhm,
    ecc, peak, npix, snr, valid, and (bg_med, bg_sig) in the first two
    cells of the last row. K is ``max_peaks``, or with None the
    data-driven capacity of ``_peaks``; a live candidate's npix is at
    least 1 (its peak), a dead slot's 0."""
    bg_med, bg_sig = _background(image, tile_size)
    threshold = bg_med + sigma_threshold * bg_sig
    py, px, vals, n_valid = _peaks(image, threshold, max_peaks)
    stats9 = window_stats(image, py, px, threshold, bg_med, n_valid)
    npixs, fluxes, cy, cx, r2m, sxx, syy, sxy, pvals = stats9.unbind(1)
    safe_flux = torch.clamp(fluxes, min=1e-30)
    fwhms = torch.sqrt(r2m / (2.0 * safe_flux)) * FWHM_FACTOR
    trace = sxx + syy
    det = torch.clamp(sxx * syy - sxy * sxy, min=0.0)
    disc = torch.sqrt(torch.clamp(trace * trace / 4.0 - det, min=0.0))
    l1 = trace / 2.0 + disc
    l2 = torch.clamp(trace / 2.0 - disc, min=0.0)
    eccs = torch.where(l1 > 1e-15, torch.clamp(torch.sqrt(torch.clamp(
        1.0 - l2 / l1, min=0.0)), 0.0, 1.0), 0.0)
    cys = cy + (py.to(torch.float32) - HALF)
    cxs = cx + (px.to(torch.float32) - HALF)
    snrs = torch.where(bg_sig <= 1e-300, 0.0, pvals / bg_sig)
    valid = (torch.isfinite(vals) & (npixs >= 3) & (npixs <= 5000)
             & (fluxes > 0.0) & (fwhms >= 0.5) & (fwhms <= 30.0))
    bg_row = torch.zeros(py.shape[0], dtype=torch.float32,
                         device=image.device)
    bg_row[0] = bg_med
    bg_row[1] = bg_sig
    return torch.stack([cys, cxs, fluxes, fwhms, eccs, pvals, npixs, snrs,
                        valid.to(torch.float32), bg_row])


def detect_stars(image, sigma_threshold: float = 5.0,
                 max_peaks: int = MAX_PEAKS,
                 device: Optional[torch.device] = None) -> DetectionResult:
    """Full detection pipeline (star_detection.rs:86-248). ``image``
    goes to ``device`` (default: its own device for a tensor, else
    ``cuda_device()``); one host fetch."""
    img = as_f32(image, device)
    rows, cols = img.shape
    if rows < 3 or cols < 3:
        return DetectionResult([], 0.0, 1.0, sigma_threshold, cols, rows)
    packed = _detect(img, _tile_size(rows, cols), float(sigma_threshold),
                     max_peaks).cpu().numpy()
    return _postprocess_packed(packed, float(sigma_threshold), rows, cols)


def detect_stars_pair(image_a, image_b, sigma_threshold: float = 5.0,
                      max_peaks: int = MAX_PEAKS,
                      device: Optional[torch.device] = None):
    """detect_stars on two same-shape planes with one host fetch (the
    alignment chain's detect × 2)."""
    a = as_f32(image_a, device)
    b = as_f32(image_b, a.device)
    rows, cols = a.shape
    if rows < 3 or cols < 3 or a.shape != b.shape:
        return (detect_stars(a, sigma_threshold, max_peaks),
                detect_stars(b, sigma_threshold, max_peaks))
    tile = _tile_size(rows, cols)
    both = torch.stack([
        _detect(a, tile, float(sigma_threshold), max_peaks),
        _detect(b, tile, float(sigma_threshold), max_peaks)]
    ).cpu().numpy()
    return (_postprocess_packed(both[0], float(sigma_threshold), rows, cols),
            _postprocess_packed(both[1], float(sigma_threshold), rows, cols))


# the 9 cells around a 3 px cell, as offsets of its key (row << 32 | col)
_CELL_OFFSETS = [dy * (1 << 32) + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_COL_BIAS = 1 << 31
# rounds of the greedy between two checks of whether it has settled
_ROUNDS_PER_CHECK = 4


def _close_pairs(cys: torch.Tensor, cxs: torch.Tensor, live: torch.Tensor):
    """(i, j) int64 of every ordered pair of distinct ``live`` candidates
    closer than DEDUPE_PX, found through a grid of DEDUPE_PX cells: a
    sort of the live cells' keys, then for each live candidate the runs
    of the 9 cells around its own (one host fetch: the pair count).
    Distances are float64 from the float32 positions, each product and
    sum rounded as ``_postprocess_packed``'s Python floats round them."""
    dev = cys.device
    k = cys.shape[0]
    ys = torch.where(live, cys, 0.0).double()
    xs = torch.where(live, cxs, 0.0).double()
    gy = torch.floor(ys / DEDUPE_PX).long()
    gx = torch.floor(xs / DEDUPE_PX).long()
    cell = gy * (1 << 32) + (gx + _COL_BIAS)
    skey, sidx = torch.sort(torch.where(live, cell,
                                        torch.iinfo(torch.int64).max))
    probe = cell[:, None] + torch.tensor(_CELL_OFFSETS, device=dev)
    lo = torch.searchsorted(skey, probe)
    cnt = torch.where(live[:, None],
                      torch.searchsorted(skey, probe, right=True) - lo, 0)
    cnt = cnt.reshape(-1)
    total = int(cnt.sum())                          # the one fetch
    run = torch.repeat_interleave(
        torch.arange(k * len(_CELL_OFFSETS), device=dev), cnt,
        output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    pos = lo.reshape(-1)[run] + (torch.arange(total, device=dev)
                                 - first[run])
    i = torch.div(run, len(_CELL_OFFSETS), rounding_mode="floor")
    j = sidx[pos]
    dy = ys[j] - ys[i]
    dx = xs[j] - xs[i]
    close = (dy * dy + dx * dx < DEDUPE_PX * DEDUPE_PX) & (i != j)
    return i[close], j[close]


def _greedy_rounds(scanned: torch.Tensor, rank: torch.Tensor,
                   i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """accepted [K] bool of the greedy over the ``scanned`` candidates in
    ``rank`` order (lower first): one is kept unless a kept one of lower
    rank lies within DEDUPE_PX. (i, j) are the close pairs. Decided in
    rounds: a candidate is dropped once a closer, earlier one is kept,
    and kept once every earlier close one is decided and none was kept;
    the earliest undecided one is decided in each round, and the rounds
    reach the sequential scan's own fixed point."""
    k = scanned.shape[0]
    edge = scanned[i] & scanned[j] & (rank[j] < rank[i])
    child, parent = i[edge], j[edge]
    undecided = scanned.clone()
    kept = torch.zeros_like(scanned)
    while True:
        for _ in range(_ROUNDS_PER_CHECK):
            by_kept = torch.zeros(k, dtype=torch.int32, device=scanned.device
                                  ).index_add_(0, child, kept[parent].int())
            by_open = torch.zeros(k, dtype=torch.int32, device=scanned.device
                                  ).index_add_(0, child,
                                               undecided[parent].int())
            keep = undecided & (by_kept == 0) & (by_open == 0)
            kept = kept | keep
            undecided = undecided & ~keep & (by_kept == 0)
        if not bool(undecided.any()):               # one fetch a check
            return kept


def dedupe_packed_device(packed: torch.Tensor,
                         scan_cap: Optional[int] = None) -> torch.Tensor:
    """Brightest-first 3 px greedy dedupe of the packed candidates
    (star_detection.rs:215), ``_postprocess_packed``'s accept set at any
    capacity. Returns accepted [K] bool on the packed array's device.

    The close pairs come from a grid of 3 px cells (``_close_pairs``), so
    the work grows with the candidates and their neighbours, not with
    K². A valid candidate with no valid one within 3 px is accepted. The
    conflicted ones are resolved brightest first (a stable sort of the
    fluxes, as ``jnp.argsort`` and the reference's ``sort_by``) by
    ``_greedy_rounds``, which keeps exactly the set the sequential scan
    keeps. Two peaks of one component can carry equal fluxes and
    centroids an ulp apart; ``_postprocess_packed``'s numpy sort is not
    stable and may keep the other twin. ``scan_cap``, the JAX
    package's bound, scans only the first ``scan_cap`` conflicted ones
    and drops the dimmer rest, as JAX does; None scans them all."""
    cys, cxs, fluxes = packed[0], packed[1], packed[2]
    valid = packed[8] > 0.5
    k = valid.shape[0]
    i, j = _close_pairs(cys, cxs, valid)
    conflicted = torch.zeros(k, dtype=torch.int32, device=valid.device
                             ).index_add_(0, i, torch.ones_like(i,
                                          dtype=torch.int32)) > 0
    order = torch.sort(torch.where(valid, -fluxes, float("inf")),
                       stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k, device=order.device)
    scanned = conflicted
    if scan_cap is not None:
        nth = torch.cumsum(conflicted[order].long(), 0) - 1
        within = torch.empty_like(conflicted)
        within[order] = nth < scan_cap
        scanned = conflicted & within
    return (valid & ~conflicted) | _greedy_rounds(scanned, rank, i, j)


def _postprocess_packed(packed: np.ndarray, sigma_threshold: float,
                        rows: int, cols: int) -> DetectionResult:
    """Brightest-first greedy 3-px dedup over a 3-px bucket grid
    (star_detection.rs:215; a copy of the JAX package's host code)."""
    (cys, cxs, fluxes, fwhms, eccs, pvals, npixs, snrs) = packed[:8]
    valid = packed[8] > 0.5
    bg_med, bg_sig = packed[9, 0], packed[9, 1]

    order = np.argsort(-fluxes)  # brightest first (star_detection.rs:215)
    cand = order[valid[order]]
    oy = cys[cand].tolist()
    ox = cxs[cand].tolist()
    lfx, lfy = fluxes[cand].tolist(), fwhms[cand].tolist()
    lec, lpk = eccs[cand].tolist(), pvals[cand].tolist()
    lnp, lsn = npixs[cand].tolist(), snrs[cand].tolist()
    grid: dict = {}
    stars: List[DetectedStar] = []
    for pos in range(len(oy)):
        y = oy[pos]
        x = ox[pos]
        cy_i = int(y) // 3
        cx_i = int(x) // 3
        clash = False
        for gy in (cy_i - 1, cy_i, cy_i + 1):
            for gx in (cx_i - 1, cx_i, cx_i + 1):
                for (sy, sx) in grid.get((gy, gx), ()):
                    dy = sy - y
                    dx = sx - x
                    if dy * dy + dx * dx < 9.0:
                        clash = True
                        break
                if clash:
                    break
            if clash:
                break
        if clash:
            continue
        grid.setdefault((cy_i, cx_i), []).append((y, x))
        stars.append(DetectedStar(
            x=x, y=y, flux=lfx[pos], fwhm=lfy[pos],
            eccentricity=lec[pos], peak=lpk[pos],
            npix=int(lnp[pos]), snr=lsn[pos]))
    return DetectionResult(stars, float(bg_med), float(bg_sig),
                           sigma_threshold, cols, rows)
