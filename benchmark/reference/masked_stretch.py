"""The shared-mask masked stretch of a colour composite, in plain PyTorch
and Python.

It follows AstroBurst's masked stretch with one luminance-derived star
mask (``core/imaging/masked_stretch.rs:42-190``,
``core/imaging/star_mask.rs:61-98``, ``core/analysis/
star_detection.rs:86-248``) as the port documents it, on the planes'
device, float32 with TF32 off:

- the composite: the three planes' robust statistics, the
  stability-reference white balance (``reference/compose.py``), each
  plane scaled by its factor unless it is within 1e-7 of 1;
- the luminance: 0.2126 R + 0.7152 G + 0.0722 B, non-finite terms 0;
- detection on the luminance, with no cap on the candidates: the tile
  background of ``reference/compose.py`` (tiles of ``min(max(min(H, W)
  // 8, 32), 256)`` pixels, two 3-sigma clips, the median of the tiles'
  medians and sigmas), threshold median + 5 sigma, every 3 x 3 local
  maximum above it (ties to the later pixel lose), one a 2 x 2 block;
  for each, the window statistics of ``reference/compose.py`` (41 x 41
  window, 20 rounds of an 8-connected fill over finite pixels above the
  threshold, moments of max(v - median, 0)); a candidate is valid with 3
  to 5000 pixels, positive flux and an FWHM in [0.5, 30];
- the dedupe: the valid candidates walked brightest first (a stable sort
  of the fluxes), each kept unless within 3 px of one kept before, the
  distances in float64 over a grid of 3 px cells, one candidate at a
  time in Python;
- the mask: each kept star with an FWHM in [1.5, 30] paints the
  smoothstep disk of radius FWHM x growth, fading to 0 over ``softness``
  more, inside its 96 x 96 window at round(position) (clipped to the
  plane), max-combined; then the luminance protection (where the
  luminance exceeds the 0.85 ceiling and the mask is below 1, the
  smoothstep of the excess over 1 - ceiling if larger) and the coverage,
  the share of pixels above 0.01;
- the stretch of each channel: its finite positive pixels normalised to
  [0, 1] over the range of its valid ones, then at most ``iterations``
  rounds of: the background, the element at sorted index n // 2 of the
  pixels with mask < 0.5 and a positive finite value; stop when it is
  within the threshold of the target (converged) or, after the first
  round, within a tenth of it of the last one; else the midtone that
  maps the background to the target, and each pixel blended as working
  x (mask x protection) + MTF(working) x (1 - mask x protection); the
  final background the same median of the result;
- the preview: each stretched channel's nearest downsample to 4096 on
  the long side and round(255 x) to u8.

Where it departs from AstroBurst, as the port does, so that the
comparison measures the port and not the reference:

- detection finds each candidate's component inside its 41 x 41 window
  from its local maximum, not by one flood fill of the whole plane: a
  component wider than the window is measured in part, and a component
  with several local maxima is measured once for each and left to the
  dedupe (the port's and the JAX package's detection);
- the stretch's background is computed in float32 throughout.

``precision`` ``"bf16"`` rounds the inputs and each stage's planes to
bfloat16 (see ``benchmark/reference/__init__.py``); star positions,
their moments and the medians stay as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import rounder
from benchmark.reference.compose import (_no_tf32, background, to_u8,
                                         white_balance, window_stats)
from benchmark.reference.stack import nearest_downsample, stats

DETECTION_SIGMA = 5.0
HALF = 20               # the window statistics' half window (41 px)
DEDUPE_PX = 3.0
MIN_FWHM, MAX_FWHM = 1.5, 30.0
MASK_WINDOW = 96
LUMA = (0.2126, 0.7152, 0.0722)
PREVIEW_MAX = 4096
FWHM_FACTOR = 2.3548200450309493
CHUNK = 8192            # candidates or stars a batch of windows


class Settings:
    """The command's defaults (``masked_stretch_composite_cmd``)."""
    iterations = 10
    target = 0.25
    growth = 2.5
    softness = 4.0
    protection = 0.85
    ceiling = 0.85
    luminance_protect = True
    threshold = 1e-5


def composite(r, g, b, q=lambda t: t):
    """The white-balanced planes the compose leaves in the composite."""
    factors = white_balance(*(stats(p) for p in (r, g, b)))
    return [p if abs(f - 1.0) < 1e-7 else q(p * f)
            for p, f in zip((r, g, b), factors)]


def luminance(r, g, b):
    parts = [torch.where(torch.isfinite(p), p, 0.0) for p in (r, g, b)]
    return LUMA[0] * parts[0] + LUMA[1] * parts[1] + LUMA[2] * parts[2]


def peaks(image: torch.Tensor, threshold: torch.Tensor):
    """(rows, cols [K] i64) of every candidate: 3 x 3 local maxima above
    the threshold, one a 2 x 2 block (its first maximum), brightest
    first."""
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
    bmax, first = blocks.max(dim=1)
    order = torch.sort(bmax, descending=True, stable=True).indices
    order = order[:int(torch.isfinite(bmax).sum())]
    by, bx = order // (c2 // 2), order % (c2 // 2)
    off = first[order]
    return 2 * by + off // 2, 2 * bx + off % 2


def detect(lum: torch.Tensor) -> dict:
    """Every valid candidate of the luminance, as host float32 arrays
    ``y``, ``x``, ``flux``, ``fwhm``; and ``candidates``, their count
    before the validity test."""
    bg_med, bg_sig = background(lum)
    threshold = bg_med + DETECTION_SIGMA * bg_sig
    py, px = peaks(lum, threshold)
    cols = {"y": [], "x": [], "flux": [], "fwhm": [], "ok": []}
    for s in range(0, py.numel(), CHUNK):
        cy, cx = py[s:s + CHUNK], px[s:s + CHUNK]
        st = window_stats(lum, cy, cx, threshold, bg_med, cy.numel())
        npix, flux, r2m = st[:, 0], st[:, 1], st[:, 4]
        fwhm = torch.sqrt(r2m / (2.0 * torch.clamp(flux, min=1e-30))) \
            * FWHM_FACTOR
        ok = ((npix >= 3) & (npix <= 5000) & (flux > 0.0) & (fwhm >= 0.5)
              & (fwhm <= 30.0))
        cols["y"].append(st[:, 2] + (cy.to(torch.float32) - HALF))
        cols["x"].append(st[:, 3] + (cx.to(torch.float32) - HALF))
        cols["flux"].append(flux)
        cols["fwhm"].append(fwhm)
        cols["ok"].append(ok)
    out = {k: torch.cat(v).cpu().numpy() if v else np.zeros(0, np.float32)
           for k, v in cols.items()}
    ok = out.pop("ok").astype(bool)
    out = {k: v[ok] for k, v in out.items()}
    out["candidates"] = int(py.numel())
    return out


def dedupe(y: np.ndarray, x: np.ndarray, flux: np.ndarray) -> np.ndarray:
    """Indices of the kept candidates, brightest first: each is kept
    unless within DEDUPE_PX of one kept before."""
    grid: dict = {}
    kept = []
    ys, xs = y.tolist(), x.tolist()
    for i in np.argsort(-flux, kind="stable").tolist():
        yi, xi = ys[i], xs[i]
        gy, gx = math.floor(yi / DEDUPE_PX), math.floor(xi / DEDUPE_PX)
        clash = any((sy - yi) * (sy - yi) + (sx - xi) * (sx - xi)
                    < DEDUPE_PX * DEDUPE_PX
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                    for sy, sx in grid.get((gy + dy, gx + dx), ()))
        if not clash:
            grid.setdefault((gy, gx), []).append((yi, xi))
            kept.append(i)
    return np.asarray(kept, np.int64)


def paint(xs, ys, radii, softness: float, h: int, w: int, device):
    """[h, w] f32: each star's soft disk inside its window,
    max-combined."""
    plane = torch.zeros(h * w + 1, dtype=torch.float32, device=device)
    off = torch.arange(MASK_WINDOW, device=device) - MASK_WINDOW // 2
    for s in range(0, len(xs), CHUNK):
        x = torch.from_numpy(xs[s:s + CHUNK]).to(device)
        y = torch.from_numpy(ys[s:s + CHUNK]).to(device)
        rad = torch.from_numpy(radii[s:s + CHUNK]).to(device)
        rows = torch.clamp(torch.round(y), 0, h).long()[:, None] + off
        cols = torch.clamp(torch.round(x), 0, w).long()[:, None] + off
        dy = rows.to(torch.float32) - y[:, None]
        dx = cols.to(torch.float32) - x[:, None]
        d2 = (dx * dx)[:, None, :] + (dy * dy)[:, :, None]
        radius = rad[:, None, None]
        outer = radius + softness
        inner2, outer2 = radius * radius, outer * outer
        fade = torch.clamp(outer2 - inner2, min=1e-10)
        t = torch.clamp((d2 - inner2) / fade, 0.0, 1.0)
        val = torch.where(d2 <= inner2, 1.0, torch.where(
            d2 <= outer2, 1.0 - t * t * (3.0 - 2.0 * t), 0.0))
        inside = ((rows >= 0) & (rows < h))[:, :, None] & \
            ((cols >= 0) & (cols < w))[:, None, :]
        idx = torch.where(inside, rows[:, :, None] * w + cols[:, None, :],
                          h * w)
        plane.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1),
                              reduce="amax")
    return plane[:h * w].reshape(h, w)


def protect(lum: torch.Tensor, mask: torch.Tensor, ceiling: float):
    c = torch.tensor(ceiling, dtype=torch.float32, device=lum.device)
    inv = 1.0 / (1.0 - c) if ceiling < 1.0 else torch.ones_like(c)
    excess = torch.clamp((lum - c) * inv, 0.0, 1.0)
    smooth = excess * excess * (3.0 - 2.0 * excess)
    return torch.where((lum > c) & (mask < 1.0), torch.maximum(mask, smooth),
                       mask)


def star_mask(lum: torch.Tensor, s=Settings, q=lambda t: t) -> dict:
    h, w = lum.shape
    det = detect(lum)
    kept = dedupe(det["y"], det["x"], det["flux"])
    fwhm = det["fwhm"][kept]
    paints = (fwhm >= MIN_FWHM) & (fwhm <= MAX_FWHM)
    sel = kept[paints]
    radii = (det["fwhm"][sel] * np.float32(s.growth)).astype(np.float32)
    mask = q(paint(det["x"][sel], det["y"][sel], radii, s.softness, h, w,
                   lum.device))
    if s.luminance_protect:
        mask = q(protect(lum, mask, s.ceiling))
    coverage = float((mask > 0.01).sum()) / (h * w)
    return {"mask": mask, "stars": int(sel.size), "coverage": coverage,
            "candidates": det["candidates"], "fwhm": det["fwhm"][sel]}


def _median(working: torch.Tensor, mask: torch.Tensor) -> float:
    vals = working[(mask < 0.5) & torch.isfinite(working) & (working > 0.0)]
    if vals.numel() == 0:
        return 0.0
    return float(torch.sort(vals).values[vals.numel() // 2])


def _mtf(x, m):
    denom = (2.0 * m - 1.0) * x - m
    small = torch.abs(denom) < 1e-10
    val = torch.clamp((m - 1.0) * x / torch.where(small, 1.0, denom),
                      0.0, 1.0)
    val = torch.where(small, x, val)
    return torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, val))


def stretch(plane: torch.Tensor, mask: torch.Tensor, s=Settings,
            q=lambda t: t) -> dict:
    """One channel's MTF loop under the mask."""
    dev = plane.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    valid = torch.isfinite(plane) & (plane > 1e-7)
    if bool(valid.any()):
        dmin = plane[valid].min()
        dmax = plane[valid].max()
    else:
        dmin = dmax = f32(0.0)
    rng = dmax - dmin
    working = torch.where(
        torch.isfinite(plane) & (plane > 0.0),
        torch.clamp((plane - dmin) / torch.clamp(rng, min=1e-30), 0.0, 1.0),
        0.0)
    working = q(torch.where(rng < 1e-10, 0.0, working))
    blend = mask * f32(s.protection)
    target, threshold = f32(s.target), f32(s.threshold)
    prev = f32(0.0)
    run, converged = 0, False
    for it in range(s.iterations):
        bg = f32(_median(working, mask))
        at_target = bool(torch.abs(bg - target) < threshold)
        stagnated = bool(torch.abs(bg - prev) < threshold * 0.1)
        run = it + 1
        if at_target or (it > 0 and stagnated):
            converged = at_target
            break
        denom = 2.0 * target * bg - target - bg
        mid = 0.5 if bool(torch.abs(denom) < 1e-15) else torch.clamp(
            bg * (target - 1.0) / denom, 0.0001, 0.9999)
        working = q(working * blend + _mtf(working, mid) * (1.0 - blend))
        prev = bg
    return {"image": torch.clamp(working, 0.0, 1.0), "iterations_run": run,
            "final_background": _median(working, mask),
            "converged": converged}


def masked_stretch_shared(r, g, b, precision: str, s=Settings) -> dict:
    """The command's results from the three channel planes as read:
    ``stars``, ``coverage``, ``candidates``, ``fwhm`` (of the painted
    stars), ``channels`` (each loop's ``iterations_run``,
    ``final_background`` and ``converged``) and the u8 ``preview``
    [H', W', 3]."""
    _no_tf32()
    q = rounder(precision)
    planes = composite(q(r), q(g), q(b), q)
    lum = q(luminance(*planes))
    sm = star_mask(lum, s, q)
    del lum
    channels, preview = [], []
    for plane in planes:
        res = stretch(plane, sm["mask"], s, q)
        preview.append(to_u8(nearest_downsample(res.pop("image"),
                                                PREVIEW_MAX)))
        channels.append(res)
    return {"stars": sm["stars"], "coverage": sm["coverage"],
            "candidates": sm["candidates"], "fwhm": sm["fwhm"],
            "channels": channels,
            "preview": torch.stack(preview, dim=-1).cpu()}
