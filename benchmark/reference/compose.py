"""The RGB compose with star-based affine alignment, white balance, STF
and SCNR, in plain PyTorch and NumPy.

It follows the compose of AstroBurst (``cmd/compose/rgb.rs:209-322``,
``core/alignment/affine.rs:129-517``) as the port documents it, on the
planes' device, float32 with TF32 off:

- harmonize: a channel smaller than the largest is resampled to it by
  separable Catmull-Rom taps at s = t * scale + (scale - 1) / 2
  (scale = source / target size), rows first, the four taps' index and
  weight vectors made on the host in float64 and the weights rounded
  to float32, summed in tap order;
- detection, on each plane: the 1st / 99.9th percentile clamp-normalize
  of ~100 000 values sampled as whole rows; the background of tiles of
  ``min(max(min(H, W) // 8, 32), 256)`` pixels (values finite and above
  1e-7), each sigma-clipped twice at 3 sigma around its median with
  sigma = 1.4826 MAD (the kept values an interval of the sorted ones),
  the median of the tiles' medians and sigmas over tiles holding 8 or
  more values; peaks: 3 x 3 local maxima above median + 3.5 sigma (ties
  to the later pixel lose), one a 2 x 2 block, the 1024 highest (ties
  to the lower index); for each, the 41 x 41 window, 20 rounds of an
  8-connected fill from its centre over finite pixels above the
  threshold, and the fill's moments of max(v - median, 0); a candidate
  is valid with 3 to 5000 pixels, positive flux and an FWHM in [0.5,
  30]; the 256 brightest valid ones (a stable sort) are walked
  brightest first, each kept unless within 3 px of one kept before,
  and the first 60 kept are the plane's stars;
- matching: the triangles of every triple of the 60 whose shortest side
  is at least 15 px, described by (middle / short, long / short) and
  their vertices ordered by the opposite side (ties by position); a
  pair of triangles whose two ratios agree within 0.02 votes for its
  three vertex pairs; pairs are taken greedily by descending votes
  (ties to the lower flat index of the 64 x 64 table), one to one;
- RANSAC over the 2000 x 3 hypothesis table of
  ``np.random.default_rng(0xDEADBEEF)``, in float64 on the host: an
  affine fit (6 or more matches) from three matches, else a rigid one
  from two; inliers within 3 px; the best hypothesis refitted on its
  inliers; kept with 4 or more inliers, at least 20% of the matches, a
  mean residual up to 5 px, a shift up to 40% of the frame, a rotation
  up to 30 degrees and scales in [0.7, 1.4]; the affine result first,
  the rigid one next; besides, RANSAC's other outcomes when errors
  within ``EDGE_PX`` of the 3 px threshold fall the other way (see
  ``ransac``), which the comparison may take in the outcome's place;
- warp: out(x, y) = Catmull-Rom 4 x 4 sample of the target at T(x, y),
  T as float32 parameters, taps clamped to the plane, rows summed first,
  0 where T(x, y) falls outside [0, W - 1) x [0, H - 1);
- colour: the robust statistics of each plane, the stability-reference
  white balance (the channel of least MAD / median keeps its level, the
  others are scaled to its median), the statistics again, each
  channel's own auto-STF (unlinked), SCNR's average-neutral green limit
  at the request's amount, and the preview: the nearest downsample to
  4096 on the long side and round(255 x) to u8.

Where it departs from those semantics, so that the comparison measures
the port and not the reference:

- the port's device chain computes RANSAC in float32 in image-centre
  normalised coordinates; this does it in float64 on raw pixels, as the
  port's host chain and affine.rs do. The two roundings put a
  hypothesis's error up to ~0.04 px apart where its three stars lie
  near a line (0.043 px the most over 41 seeds of the full frame, most
  of it the float32 fit, the rest centroids up to 5e-4 px apart), so a
  match within that of the threshold can make the device chain count
  one inlier more or fewer and refit on another set: the outcomes
  within ``EDGE_PX`` = 0.1 px of the threshold are kept beside the
  outcome, for the comparison;
- the star chain's phase-correlation fallback is not reproduced: a
  target that the stars do not align reads as method ``failed``, with
  the identity, and the comparison counts it;
- a transform whose linear part is exactly the identity is warped by the
  direct sampler here, not by the separable shift.

``precision`` ``"bf16"`` rounds the inputs and each stage's planes to
bfloat16 (see ``benchmark/reference/__init__.py``); star positions and
the fits stay as they are.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from benchmark.reference import rounder
from benchmark.reference.stack import (catmull_rom, nearest_downsample,
                                       stats)

PADDING = 1e-7
MAD_TO_SIGMA = 1.4826
DETECTION_SIGMA = 3.5
MAX_PEAKS = 1024
WINDOW = 41
HALF = WINDOW // 2
SCAN_CAP = 256
N_STARS = 60
STAR_CAP = 64
MIN_SIDE = 15.0
TOLERANCE = 0.02
RANSAC_PX = 3.0
EDGE_PX = 0.1
EDGE_SUBSETS = 6
MIN_AFFINE, MIN_RIGID = 6, 4
MIN_INLIER_RATIO = 0.20
MAX_RESIDUAL_PX = 5.0
MAX_OFFSET_FRACTION = 0.40
MAX_ROTATION_DEG = 30.0
MIN_SCALE, MAX_SCALE = 0.70, 1.40
PREVIEW_MAX = 4096
FWHM_FACTOR = 2.3548200450309493
HYPOTHESES = np.random.default_rng(0xDEADBEEF).random(
    (2000, 3)).astype(np.float32)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- harmonize -----------------------------------------------------------


def _taps(image: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    src = int(image.shape[axis])
    scale = src / n
    s = np.arange(n) * scale + (scale - 1.0) * 0.5
    i0 = np.floor(s).astype(np.int64)
    f = s - i0
    out = None
    for j in range(4):
        a = np.abs(f - (j - 1))
        w = np.where(a <= 1.0, a * a * (1.5 * a - 2.5) + 1.0, np.where(
            a <= 2.0, a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0, 0.0))
        wt = torch.from_numpy(w.astype(np.float32)).to(image.device)
        wt = wt[:, None] if axis == 0 else wt[None, :]
        idx = torch.from_numpy(np.clip(i0 + j - 1, 0, src - 1)).to(
            image.device)
        term = wt * image.index_select(axis, idx)
        out = term if out is None else out + term
    return out


def resample(image: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(image.shape) == (rows, cols):
        return image
    return _taps(_taps(image, rows, 0), cols, 1)


def harmonize(r, g, b):
    """(r, g, b on the largest grid, rows, cols, resampled)."""
    rows = max(int(p.shape[0]) for p in (r, g, b))
    cols = max(int(p.shape[1]) for p in (r, g, b))
    same = all(tuple(p.shape) == (rows, cols) for p in (r, g, b))
    return (resample(r, rows, cols), resample(g, rows, cols),
            resample(b, rows, cols), rows, cols, not same)


# --- detection -----------------------------------------------------------


def normalize(image: torch.Tensor) -> torch.Tensor:
    rows, cols = image.shape
    dev = image.device
    n_rows = max(min(-(-100_000 // cols), rows), 1)
    step = torch.tensor(rows / n_rows, dtype=torch.float32)
    ridx = torch.clamp((torch.arange(n_rows, dtype=torch.float32) * step)
                       .to(torch.int64), max=rows - 1).to(dev)
    samples = image[ridx].reshape(-1)
    finite = samples[torch.isfinite(samples)]
    cnt = int(finite.numel())
    svals = torch.sort(finite).values
    m = samples.numel()
    if cnt == 0:
        return image
    lo = svals[min(max(cnt // 100, 0), m - 1, cnt - 1)]
    hi = svals[min(max(cnt * 999 // 1000, 0), m - 1, cnt - 1)]
    rng = hi - lo
    if cnt < 100 or float(rng) < 1e-15:
        return image
    return torch.clamp((image - lo) / rng, 0.0, 1.0)


def _median_sorted(v: torch.Tensor) -> torch.Tensor:
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def _tile_stats(vals: torch.Tensor):
    """(median, sigma) of one tile's valid values after two 3-sigma
    clips; None for an empty tile."""
    v = torch.sort(vals).values
    lo, hi = 0, v.numel()

    def med_sig(lo, hi):
        part = v[lo:hi]
        med = _median_sorted(part)
        mad = _median_sorted(torch.sort(torch.abs(part - med)).values)
        return med, torch.clamp(mad * MAD_TO_SIGMA, min=1e-30)

    for _ in range(2):
        if hi - lo < 3:
            continue
        med, sig = med_sig(lo, hi)
        lo = max(int((v < med - 3.0 * sig).sum()), lo)
        hi = min(int((v <= med + 3.0 * sig).sum()), hi)
    if hi <= lo:
        return None
    return med_sig(lo, hi)


def background(image: torch.Tensor):
    """(median, sigma) 0-d f32 of the tile background."""
    rows, cols = image.shape
    step = max(min(max(min(rows, cols) // 8, 32), 256), 16)
    meds, sigs = [], []
    for y0 in range(0, rows, step):
        for x0 in range(0, cols, step):
            t = image[y0:y0 + step, x0:x0 + step].reshape(-1)
            t = t[torch.isfinite(t) & (t > PADDING)]
            if t.numel() < 8:
                continue
            got = _tile_stats(t)
            if got is None:
                med, sig = (torch.zeros((), device=image.device),
                            torch.ones((), device=image.device))
            else:
                med, sig = got
            meds.append(med)
            sigs.append(sig)
    if not meds:
        return (torch.zeros((), device=image.device),
                torch.ones((), device=image.device))
    k = len(meds) // 2
    med = torch.sort(torch.stack(meds)).values[k]
    sig = torch.sort(torch.stack(sigs)).values[k]
    return med, torch.clamp(sig, min=1e-10)


def peaks(image: torch.Tensor, threshold: torch.Tensor):
    """(rows, cols [K] i64, values [K] f32 with -inf past the valid
    ones, the count of valid ones)."""
    rows, cols = image.shape
    finite = torch.isfinite(image)
    img = torch.where(finite, image, float("-inf"))
    p = torch.nn.functional.pad(img, (1, 1, 1, 1), value=float("-inf"))
    is_max = finite & (image > threshold)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            nb = p[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            is_max &= (img > nb) if (dy, dx) > (0, 0) else (img >= nb)
    is_max[0, :] = is_max[-1, :] = False
    is_max[:, 0] = is_max[:, -1] = False
    score = torch.where(is_max, image, float("-inf"))
    r2, c2 = -(-rows // 2) * 2, -(-cols // 2) * 2
    sp = torch.nn.functional.pad(score, (0, c2 - cols, 0, r2 - rows),
                                 value=float("-inf"))
    blocks = sp.reshape(r2 // 2, 2, c2 // 2, 2).permute(0, 2, 1, 3).reshape(
        -1, 4)
    bmax, first = blocks.max(dim=1)          # the first of equal maxima
    order = torch.sort(bmax, descending=True, stable=True).indices
    order = order[:MAX_PEAKS]
    vals = bmax[order]
    by, bx = order // (c2 // 2), order % (c2 // 2)
    off = first[order]
    py, px = 2 * by + off // 2, 2 * bx + off % 2
    k = order.numel()
    if k < MAX_PEAKS:
        pad = MAX_PEAKS - k
        vals = torch.cat([vals, vals.new_full((pad,), float("-inf"))])
        py = torch.cat([py, py.new_zeros(pad)])
        px = torch.cat([px, px.new_zeros(pad)])
    return py, px, vals, int(torch.isfinite(vals).sum())


def window_stats(image, py, px, threshold, bg_med, n_valid: int):
    """[K, 9] f32: npix, flux, cy, cx (window-relative), r2m, sxx, syy,
    sxy, peak of each candidate's fill; zero rows past ``n_valid``."""
    dev = image.device
    padded = torch.nn.functional.pad(image, (HALF,) * 4, value=float("nan"))
    ar = torch.arange(WINDOW, device=dev)
    win = padded[(py[:, None] + ar)[:, :, None], (px[:, None] + ar)[:, None]]
    above = torch.isfinite(win) & (win > threshold)
    member = torch.zeros_like(above)
    member[:, HALF, HALF] = True
    for _ in range(HALF):
        m = torch.nn.functional.pad(member, (1, 1, 1, 1))
        grown = member.clone()
        for dy in range(3):
            for dx in range(3):
                grown |= m[:, dy:dy + WINDOW, dx:dx + WINDOW]
        member = grown & above
    v = torch.where(member, torch.clamp(win - bg_med, min=0.0), 0.0)
    npix = member.sum(dim=(1, 2)).to(torch.float32)
    flux = v.sum(dim=(1, 2))
    yy = torch.arange(WINDOW, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(WINDOW, dtype=torch.float32, device=dev)[None, None, :]
    safe = torch.clamp(flux, min=1e-30)
    cy = (yy * v).sum(dim=(1, 2)) / safe
    cx = (xx * v).sum(dim=(1, 2)) / safe
    dy = yy - cy[:, None, None]
    dx = xx - cx[:, None, None]
    out = torch.stack([npix, flux, cy, cx,
                       ((dx * dx + dy * dy) * v).sum(dim=(1, 2)),
                       (dx * dx * v).sum(dim=(1, 2)) / safe,
                       (dy * dy * v).sum(dim=(1, 2)) / safe,
                       (dx * dy * v).sum(dim=(1, 2)) / safe,
                       v.amax(dim=(1, 2))], dim=1)
    live = torch.arange(out.shape[0], device=dev) < n_valid
    return torch.where(live[:, None], out, 0.0)


def detect(plane: torch.Tensor, q=lambda t: t):
    """(xs, ys) float64 numpy [n <= 60] of the plane's stars, brightest
    first."""
    image = q(normalize(plane))
    bg_med, bg_sig = background(image)
    threshold = bg_med + DETECTION_SIGMA * bg_sig
    py, px, vals, n_valid = peaks(image, threshold)
    st = window_stats(image, py, px, threshold, bg_med, n_valid)
    npix, flux, cy, cx, r2m = st[:, 0], st[:, 1], st[:, 2], st[:, 3], st[:, 4]
    fwhm = torch.sqrt(r2m / (2.0 * torch.clamp(flux, min=1e-30))) \
        * FWHM_FACTOR
    ys = cy + (py.to(torch.float32) - HALF)
    xs = cx + (px.to(torch.float32) - HALF)
    valid = (torch.isfinite(vals) & (npix >= 3) & (npix <= 5000)
             & (flux > 0.0) & (fwhm >= 0.5) & (fwhm <= 30.0))
    order = torch.sort(torch.where(valid, -flux, float("inf")),
                       stable=True).indices[:SCAN_CAP]
    ys, xs, ok = (t[order].cpu().numpy() for t in (ys, xs, valid))
    keep = []
    for i in range(len(order)):
        if not ok[i]:
            continue
        if any((ys[k] - ys[i]) * (ys[k] - ys[i]) + (xs[k] - xs[i])
               * (xs[k] - xs[i]) < np.float32(9.0) for k in keep):
            continue
        keep.append(i)
    keep = keep[:N_STARS]
    return xs[keep].astype(np.float64), ys[keep].astype(np.float64)


# --- matching ------------------------------------------------------------


def triangles(xs: np.ndarray, ys: np.ndarray, device):
    """(ratios [T, 2] f32, vertices [T, 3] i64) of the kept triangles."""
    n = len(xs)
    x = torch.tensor(xs, dtype=torch.float32, device=device)
    y = torch.tensor(ys, dtype=torch.float32, device=device)
    if n < 3:
        return (torch.zeros((0, 2), device=device),
                torch.zeros((0, 3), dtype=torch.int64, device=device))
    tri = torch.combinations(torch.arange(n, device=device), 3)
    i, j, k = tri.unbind(1)

    def side(a, b):
        dx, dy = x[a] - x[b], y[a] - y[b]
        return torch.sqrt(dx * dx + dy * dy)

    d_ij, d_jk, d_ik = side(i, j), side(j, k), side(i, k)
    sides = torch.sort(torch.stack([d_ij, d_jk, d_ik], 1), dim=1).values
    keep = sides[:, 0] >= MIN_SIDE
    ratios = torch.stack([sides[:, 1] / sides[:, 0],
                          sides[:, 2] / sides[:, 0]], 1)[keep]
    opp = torch.stack([d_jk, d_ik, d_ij], 1)[keep]
    order = torch.sort(opp, dim=1, stable=True).indices
    verts = torch.gather(tri[keep], 1, order)
    return ratios, verts


def vote_table(ref_tris, tgt_tris) -> np.ndarray:
    """[64, 64] int64: votes[a, b] counts the pairs of triangles within
    TOLERANCE on both ratios whose p-th vertices are a and b."""
    rr, rv = ref_tris
    tr, tv = tgt_tris
    dev = rr.device
    votes = torch.zeros(STAR_CAP * STAR_CAP, dtype=torch.int64, device=dev)
    if rr.shape[0] == 0 or tr.shape[0] == 0:
        return votes.reshape(STAR_CAP, STAR_CAP).cpu().numpy()
    ro = torch.sort(rr[:, 0]).indices
    rr, rv = rr[ro], rv[ro]
    to = torch.sort(tr[:, 0]).indices
    tr, tv = tr[to], tv[to]
    t0 = tr[:, 0].contiguous()
    for c in range(0, rr.shape[0], 1024):
        r, v = rr[c:c + 1024], rv[c:c + 1024]
        lo = int(torch.searchsorted(t0, r[0, 0] - 2 * TOLERANCE))
        hi = int(torch.searchsorted(t0, r[-1, 0] + 2 * TOLERANCE,
                                    right=True))
        t, w = tr[lo:hi], tv[lo:hi]
        m = ((torch.abs(r[:, None, 0] - t[None, :, 0]) <= TOLERANCE)
             & (torch.abs(r[:, None, 1] - t[None, :, 1]) <= TOLERANCE))
        a, b = torch.nonzero(m, as_tuple=True)
        for p in range(3):
            votes += torch.bincount(v[a, p] * STAR_CAP + w[b, p],
                                    minlength=STAR_CAP * STAR_CAP)
    return votes.reshape(STAR_CAP, STAR_CAP).cpu().numpy()


def greedy_pairs(votes: np.ndarray):
    """(ref, target) star pairs by descending votes, one to one."""
    v = votes.astype(np.int64).copy()
    pairs = []
    for _ in range(STAR_CAP):
        idx = int(np.argmax(v))
        if v.flat[idx] < 1:
            break
        ri, ti = divmod(idx, STAR_CAP)
        pairs.append((ri, ti))
        v[ri, :] = -1
        v[:, ti] = -1
    return pairs


def _fit_affine(m: np.ndarray):
    a = np.stack([m[:, 0], m[:, 1], np.ones(len(m))], 1)
    ata = a.T @ a
    if len(m) < 3 or abs(np.linalg.det(ata)) < 1e-12:
        return None
    sx = np.linalg.solve(ata, a.T @ m[:, 2])
    sy = np.linalg.solve(ata, a.T @ m[:, 3])
    return (sx[0], sx[1], sx[2], sy[0], sy[1], sy[2])


def _fit_rigid(m: np.ndarray):
    if len(m) < 2:
        return None
    rcx, rcy, tcx, tcy = m.mean(0)
    drx, dry = m[:, 0] - rcx, m[:, 1] - rcy
    dtx, dty = m[:, 2] - tcx, m[:, 3] - tcy
    th = math.atan2(float((drx * dty - dry * dtx).sum()),
                    float((drx * dtx + dry * dty).sum()))
    c, s = math.cos(th), math.sin(th)
    return (c, -s, tcx - c * rcx + s * rcy, s, c, tcy - s * rcx - c * rcy)


def _hypotheses(m: np.ndarray, method: str) -> list:
    """Each hypothesis's transform, None where its sample is degenerate."""
    n = len(m)
    k = 3 if method == "affine" else 2
    idx = np.minimum((HYPOTHESES[:, :k] * n).astype(np.int64), n - 1)
    out = []
    for h in range(len(idx)):
        s = m[idx[h]]
        if method == "affine":
            a = np.stack([s[:, 0], s[:, 1], np.ones(3)], 1)
            if abs(np.linalg.det(a)) <= 1e-9:
                out.append(None)
                continue
            px, py = np.linalg.solve(a, s[:, 2]), np.linalg.solve(a, s[:, 3])
            out.append((px[0], px[1], px[2], py[0], py[1], py[2]))
        else:
            d = s - s.mean(0)
            num = float((d[:, 0] * d[:, 3] - d[:, 1] * d[:, 2]).sum())
            den = float((d[:, 0] * d[:, 2] + d[:, 1] * d[:, 3]).sum())
            out.append(None if abs(num) + abs(den) <= 1e-12
                       else _fit_rigid(s))
    return out


def _outcome(m: np.ndarray, inl: np.ndarray, method: str, t):
    """(refined transform, inliers, residual) of one inlier mask, or None
    where the gates refuse it."""
    n, count = len(m), int(inl.sum())
    if count < MIN_RIGID or count / n < MIN_INLIER_RATIO:
        return None
    refined = (_fit_affine(m[inl]) if method == "affine"
               else _fit_rigid(m[inl])) or t
    resid = float(np.sqrt(_err2(m[inl], refined)).mean())
    if resid > MAX_RESIDUAL_PX:
        return None
    return refined, count, resid


def ransac(m: np.ndarray, method: str) -> list:
    """[(transform (a, b, tx, c, d, ty), inliers, residual), ...]: the
    outcome first, then the other outcomes at the threshold's edge; []
    where the outcome fails the gates.

    An inlier is an error under RANSAC_PX, so a match whose error lies
    within EDGE_PX of it can fall either way under another rounding of
    the same fit: float32 against float64, centroids 1e-4 px apart. The
    other outcomes are those of the first hypothesis of most inliers
    when any such error is moved across the threshold: each hypothesis
    that can then come first (more inliers than every earlier one, at
    least as many as every later one), with each choice of its edge
    matches that gives it that many."""
    n = len(m)
    if n < (3 if method == "affine" else 2):
        return []
    ts = _hypotheses(m, method)
    live = np.array([t is not None for t in ts])
    if not live.any():
        return []
    e2 = np.full((len(ts), n), np.inf)
    for h, t in enumerate(ts):
        if t is not None:
            e2[h] = _err2(m, t)
    strict = e2 < RANSAC_PX ** 2
    count = np.where(live, strict.sum(1), -1)
    best = int(np.argmax(count))
    first = _outcome(m, strict[best], method, ts[best])
    if first is None:
        return []
    sure = e2 < (RANSAC_PX - EDGE_PX) ** 2
    edge = (e2 < (RANSAC_PX + EDGE_PX) ** 2) & ~sure
    lo = np.where(live, sure.sum(1), -1)
    hi = np.where(live, (sure | edge).sum(1), -1)
    before = np.concatenate([[-1], np.maximum.accumulate(lo)[:-1]])
    after = np.concatenate([np.maximum.accumulate(lo[::-1])[::-1][1:],
                            [-1]])
    seen = {tuple(np.flatnonzero(strict[best]))}
    out = [first]
    for h in np.flatnonzero(live & (hi > before) & (hi >= after)):
        need = max(int(before[h]) + 1, int(after[h])) - int(sure[h].sum())
        cols = np.flatnonzero(edge[h])
        for pick in _subsets(len(cols), max(need, 0)):
            inl = sure[h].copy()
            inl[cols[list(pick)]] = True
            key = tuple(np.flatnonzero(inl))
            if key in seen:
                continue
            seen.add(key)
            got = _outcome(m, inl, method, ts[h])
            if got is not None:
                out.append(got)
    return out


def _subsets(k: int, least: int):
    """The index tuples of at least ``least`` of ``k`` edge matches; past
    EDGE_SUBSETS of them only none and all."""
    if k > EDGE_SUBSETS:
        return [p for p in ((), tuple(range(k))) if len(p) >= least]
    return [p for r in range(max(least, 0), k + 1)
            for p in itertools.combinations(range(k), r)]


def _err2(m: np.ndarray, t) -> np.ndarray:
    a, b, tx, c, d, ty = t
    return (a * m[:, 0] + b * m[:, 1] + tx - m[:, 2]) ** 2 + \
        (c * m[:, 0] + d * m[:, 1] + ty - m[:, 3]) ** 2


def sane(t, rows: int, cols: int) -> bool:
    a, b, tx, c, d, ty = t
    return (abs(tx) <= cols * MAX_OFFSET_FRACTION
            and abs(ty) <= rows * MAX_OFFSET_FRACTION
            and abs(math.degrees(math.atan2(c, a))) <= MAX_ROTATION_DEG
            and MIN_SCALE <= math.hypot(a, c) <= MAX_SCALE
            and MIN_SCALE <= math.hypot(b, d) <= MAX_SCALE)


def align(ref, tgt, rows: int, cols: int, device) -> dict:
    """The transform of reference pixels to target pixels from two star
    lists ((xs, ys) each): {"transform", "method", "matched", "inliers",
    "edge"}, ``edge`` the transforms of RANSAC's other outcomes at its
    threshold's edge (``ransac``) that pass the sanity gates."""
    pairs = greedy_pairs(vote_table(triangles(*ref, device),
                                    triangles(*tgt, device)))
    m = np.array([(ref[0][i], ref[1][i], tgt[0][j], tgt[1][j])
                  for i, j in pairs], dtype=np.float64).reshape(-1, 4)
    for method in ("affine", "rigid"):
        if len(m) < (MIN_AFFINE if method == "affine" else MIN_RIGID):
            continue
        got = ransac(m, method)
        if got and sane(got[0][0], rows, cols):
            return {"transform": tuple(float(v) for v in got[0][0]),
                    "method": method, "matched": len(m),
                    "inliers": got[0][1],
                    "edge": [tuple(float(v) for v in t)
                             for t, _, _ in got[1:] if sane(t, rows, cols)]}
    return {"transform": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0), "method": "failed",
            "matched": len(m), "inliers": 0, "edge": []}


def warp(image: torch.Tensor, t, rows: int, cols: int) -> torch.Tensor:
    """out[y, x] = Catmull-Rom sample of ``image`` at T(x, y)."""
    dev = image.device
    a, b, tx, c, d, ty = torch.tensor(t, dtype=torch.float32,
                                      device=dev).unbind()
    y = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(cols, dtype=torch.float32, device=dev)[None, :]
    sx = a * x + b * y + tx
    sy = c * x + d * y + ty
    ix, iy = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - ix, sy - iy
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    src_rows, src_cols = image.shape
    flat = image.reshape(-1)
    out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    for j in range(4):
        wy = catmull_rom(fy - (j - 1))
        r = torch.clamp(iy + (j - 1), 0, src_rows - 1)
        row = torch.zeros_like(out)
        for i in range(4):
            wx = catmull_rom(fx - (i - 1))
            cc = torch.clamp(ix + (i - 1), 0, src_cols - 1)
            row = row + wx * flat[r * src_cols + cc]
        out = out + wy * row
    inside = (sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) & \
        (sy < src_rows - 1)
    return torch.where(inside, out, 0.0)


# --- colour --------------------------------------------------------------


def white_balance(sr: dict, sg: dict, sb: dict):
    """(r, g, b) factors: the channel of least MAD / median is kept."""
    def stability(s):
        return s["mad"] / s["median"] if s["median"] > 1e-10 else math.inf

    def med(s):
        return max(s["median"], 1e-10)

    r, g, b = stability(sr), stability(sg), stability(sb)
    if r <= g and r <= b:
        return 1.0, med(sr) / med(sg), med(sr) / med(sb)
    if b <= g:
        return med(sb) / med(sr), med(sb) / med(sg), 1.0
    return med(sg) / med(sr), 1.0, med(sg) / med(sb)


def auto_stf(st: dict, target_bg: float = 0.25,
             shadow_k: float = -2.8) -> dict:
    """(shadow, midtone, highlight) from ``stats``, host f64 math in the
    order stf.rs writes it."""
    if st["count"] == 0:
        return {"shadow": 0.0, "midtone": 0.5, "highlight": 1.0}
    rng = max(st["max"] - st["min"], 1e-30)
    med = (st["median"] - st["min"]) / rng
    shadow = min(max(med + shadow_k * (st["sigma"] / rng), 0.0), 0.98)
    m = min(max((med - shadow) / max(1.0 - shadow, 1e-15), 0.0), 1.0)
    mid = 0.5
    if 0.0 < m < 1.0:
        denom = 2.0 * target_bg * m - target_bg - m
        if abs(denom) >= 1e-15:
            mid = min(max(m * (target_bg - 1.0) / denom, 0.0001), 0.9999)
    return {"shadow": shadow, "midtone": mid, "highlight": 1.0}


def stf_f32(x: torch.Tensor, st: dict, stf: dict) -> torch.Tensor:
    """The STF of x in f32 from host parameters rounded to f32; invalid
    pixels 0."""
    rng = max(st["max"] - st["min"], 1e-30)
    clip = max(stf["highlight"] - stf["shadow"], 1e-15)
    dmin, inv_rng, shadow, inv_clip, mid = torch.tensor(
        [st["min"], 1.0 / rng, stf["shadow"], 1.0 / clip, stf["midtone"]],
        dtype=torch.float32).to(x.device).unbind()
    c = torch.clamp(((x - dmin) * inv_rng - shadow) * inv_clip, 0.0, 1.0)
    s = (mid - 1.0) * c / ((2.0 * mid - 1.0) * c - mid)
    s = torch.where(c <= 0.0, torch.zeros_like(c),
                    torch.where(c >= 1.0, torch.ones_like(c), s))
    valid = torch.isfinite(x) & (x > PADDING)
    return torch.where(valid, s, torch.zeros_like(s))


def scnr_average(r, g, b, amount: float):
    amt = torch.tensor(min(max(amount, 0.0), 1.0),
                       dtype=torch.float32).to(g.device)
    limit = (r + b) * 0.5
    return r, g + amt * (torch.minimum(g, limit) - g), b


def to_u8(x: torch.Tensor) -> torch.Tensor:
    clean = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(torch.round(clean * 255.0), 0, 255).to(torch.uint8)


def color(r, g, b, scnr_amount: float, q=lambda t: t) -> dict:
    """Statistics, white balance, STF, SCNR and the u8 preview [H', W',
    3] of three aligned planes: the statistics before and after the
    balance, the STF parameters, the factors, the balanced planes, the
    stretched ones after SCNR, and the preview."""
    before = [stats(p) for p in (r, g, b)]
    factors = white_balance(*before)
    planes = [p if abs(f - 1.0) < 1e-7 else q(p * f)
              for p, f in zip((r, g, b), factors)]
    after = [stats(p) for p in planes]
    stfs = [auto_stf(s) for s in after]
    stretched = [q(stf_f32(p, s, f)) for p, s, f in zip(planes, after,
                                                          stfs)]
    stretched = [q(p) for p in scnr_average(*stretched, scnr_amount)]
    preview = torch.stack([to_u8(nearest_downsample(p, PREVIEW_MAX))
                           for p in stretched], dim=-1)
    return {"stats": before, "stats_wb": after, "stf": stfs,
            "factors": factors, "planes": planes, "stretched": stretched,
            "preview": preview.cpu()}


def compose(r, g, b, precision: str, scnr_amount: float = 1.0) -> dict:
    """The whole compose of three planes (R the reference channel); its
    ``harmonized`` planes are kept for ``finish`` with other
    transforms."""
    _no_tf32()
    q = rounder(precision)
    r, g, b = q(r), q(g), q(b)
    r, g, b, rows, cols, resampled = harmonize(r, g, b)
    r, g, b = q(r), q(g), q(b)
    ref = detect(r, q)
    out = {"dimensions": [cols, rows], "resampled": resampled,
           "harmonized": (r, g, b)}
    for name, plane in (("g", g), ("b", b)):
        out[name] = align(ref, detect(plane, q), rows, cols, plane.device)
    out.update(finish(r, g, b, [out["g"]["transform"],
                                out["b"]["transform"]],
                      precision, scnr_amount))
    return out


def finish(r, g, b, transforms, precision: str,
           scnr_amount: float = 1.0) -> dict:
    """``color`` of R and of G and B warped by their ``transforms``."""
    q = rounder(precision)
    rows, cols = r.shape
    warped = [q(warp(p, t, rows, cols)) for p, t in zip((g, b), transforms)]
    return color(r, *warped, scnr_amount, q)
