"""Iterative masked MTF stretch (counterpart of
astroburst_tpu/imaging/masked_stretch.py).

Reference: src-tauri/src/core/imaging/masked_stretch.rs — normalize to
[0, 1], star mask once, then loop ≤ N: masked-background median →
mtf_balance → blend dst = dst·(m·α) + stretched·(1 − m·α); stop when
|bg − target| < threshold or the background stagnates. RGB uses a
shared luminance-derived mask (masked_stretch.rs:157-190).

``masked_stretch`` and ``masked_stretch_rgb_shared`` (on the BT.709
luminance) build the star mask on the device: detection (kernels K10
and K11) with a capacity that follows the data, the exact 3 px dedupe of
``dedupe_packed_device``, the FWHM filter and the paint (K13), so every
star the reference's detection keeps is masked (ROADMAP C49: the JAX
package caps them at 4096 and 1024 peaks and 512 conflicted ones;
``masked_stretch``'s ``max_peaks`` and ``star_mask_device``'s
``max_peaks`` and ``scan_cap`` take those caps back). The host
reads the candidates' count once, the dedupe's pair count and its
settling checks, the mask's counts once, and the loop's stop flags once
per iteration.

Differences from the JAX module:

- the masked median is the reference's select_nth(len/2), the element
  at sorted index cnt // 2, by exact selection (``torch.sort`` read at a
  device-side index, as ops/stats.py does); the JAX compare-count
  ``masked_rank_values`` lies within ~4e-6 of it on [0, 1], so the stop
  tests can fall on another iteration than JAX's at the default
  threshold (ROADMAP C12);
- the loop runs on the host, one small fetch per iteration (the stop
  flags, computed on the device in f32), instead of a device
  ``while_loop``: a run that stops after 4 iterations pays for 4, as in
  JAX. The stopping iteration leaves ``working`` unchanged and counts
  in ``iterations_run`` (masked_stretch.py:113-115).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from astroburst_tpu_torch.analysis import star_detection as SD
from astroburst_tpu_torch.imaging import star_mask as SM
from astroburst_tpu_torch.imaging.star_mask import (StarMaskConfig,
                                                    StarMaskResult)
from astroburst_tpu_torch.ops.masking import validity_mask
from astroburst_tpu_torch.ops.stats import select_half
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import as_f32


@dataclass
class MaskedStretchConfig:
    iterations: int = 10
    target_background: float = 0.25
    mask_growth: float = 2.5
    mask_softness: float = 4.0
    luminance_protect: bool = True
    luminance_ceiling: float = 0.85
    protection_amount: float = 0.85
    convergence_threshold: float = 1e-5


@dataclass
class MaskedStretchResult:
    image: torch.Tensor
    iterations_run: int
    final_background: float
    stars_masked: int
    mask_coverage: float
    converged: bool


def _masked_median(working: torch.Tensor,
                   bg_mask: torch.Tensor) -> torch.Tensor:
    """select_nth(len/2) of the pixels where ``bg_mask`` holds
    (masked_stretch.rs:211-228): sorted index cnt // 2; 0 when none."""
    return select_half(torch.where(bg_mask, working, float("inf"))
                       .reshape(-1), bg_mask.sum())


def _mtf_guarded(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """MTF with |denom| < 1e-10 → x guard (masked_stretch.rs:238-252)."""
    denom = (2.0 * m - 1.0) * x - m
    small = torch.abs(denom) < 1e-10
    safe = torch.where(small, 1.0, denom)
    val = torch.clamp((m - 1.0) * x / safe, 0.0, 1.0)
    val = torch.where(small, x, val)
    return torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, val))


def _background_mask(working: torch.Tensor, mask: torch.Tensor):
    return (mask < 0.5) & torch.isfinite(working) & (working > 0.0)


def _stretch_core(image: torch.Tensor, mask: torch.Tensor,
                  config: MaskedStretchConfig):
    """(image [h, w] in [0, 1], iterations_run, final_background,
    converged). Normalization bounds are the validity-masked min/max
    (stats.rs:11 semantics); the scalars of the configuration are f32
    tensors, as the JAX function takes them."""
    dev = image.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    protection = f32(config.protection_amount)
    target_bg = f32(config.target_background)
    threshold = f32(config.convergence_threshold)
    vm = validity_mask(image)
    any_valid = vm.any()
    dmin = torch.where(any_valid, torch.where(vm, image, float("inf")).min(),
                       0.0)
    dmax = torch.where(any_valid, torch.where(vm, image, float("-inf")).max(),
                       0.0)
    rng = dmax - dmin
    working = torch.where(
        torch.isfinite(image) & (image > 0.0),
        torch.clamp((image - dmin) / torch.clamp(rng, min=1e-30), 0.0, 1.0),
        0.0)
    working = torch.where(rng < 1e-10, 0.0, working)
    blend = mask * protection

    iterations_run, converged, stopped = 0, False, False
    prev_bg = f32(0.0)
    for it in range(config.iterations):
        bg = _masked_median(working, _background_mask(working, mask))
        at_target = torch.abs(bg - target_bg) < threshold
        stagnated = torch.abs(bg - prev_bg) < threshold * 0.1
        # mtf_balance (masked_stretch.rs:230-236)
        denom = 2.0 * target_bg * bg - target_bg - bg
        tiny = torch.abs(denom) < 1e-15
        midtone = torch.where(tiny, 0.5, torch.clamp(
            bg * (target_bg - 1.0) / torch.where(tiny, 1.0, denom),
            0.0001, 0.9999))
        stretched = _mtf_guarded(working, midtone)
        new_working = working * blend + stretched * (1.0 - blend)
        flags = torch.stack([at_target, stagnated]).tolist()  # one fetch
        iterations_run = it + 1
        if flags[0] or (it > 0 and flags[1]):
            converged, stopped = flags[0], True
            break
        working, prev_bg = new_working, bg

    final_bg = _masked_median(working, _background_mask(working, mask))
    trace.count("stretch.masked.iterations", iterations_run)
    trace.count("stretch.masked.loops")
    trace.count("stretch.masked.ran_out", int(not stopped))
    return (torch.clamp(working, 0.0, 1.0), iterations_run, float(final_bg),
            converged)


def masked_stretch_with_mask(image, mask_result: StarMaskResult,
                             config: MaskedStretchConfig,
                             device: Optional[torch.device] = None
                             ) -> MaskedStretchResult:
    """The MTF loop of ``image`` under a finished star mask."""
    img = as_f32(image, device)
    out, iters, final_bg, converged = _stretch_core(
        img, mask_result.mask.to(img.device), config)
    return MaskedStretchResult(
        image=out, iterations_run=iters, final_background=final_bg,
        stars_masked=mask_result.stars_masked,
        mask_coverage=mask_result.coverage_fraction, converged=converged)


def _mask_config(config: MaskedStretchConfig) -> StarMaskConfig:
    return StarMaskConfig(
        growth_factor=config.mask_growth, softness=config.mask_softness,
        luminance_protect=config.luminance_protect,
        luminance_ceiling=config.luminance_ceiling)


def _paint_records(packed: torch.Tensor, mask_cfg: StarMaskConfig,
                   scan_cap: Optional[int] = None):
    """(xs, ys, radii [K] f32, painted count 0-d) of the packed detection
    records: the device dedupe's accept set, FWHM-filtered, with radius
    FWHM·growth; unpainted slots are zeroed, since they can carry NaN
    positions (masked_stretch.py:171-180)."""
    accepted = SD.dedupe_packed_device(packed, scan_cap)
    fwhms = packed[3]
    painted = accepted & (fwhms >= mask_cfg.min_fwhm) & \
        (fwhms <= mask_cfg.max_fwhm)
    return (torch.where(painted, packed[1], 0.0),
            torch.where(painted, packed[0], 0.0),
            torch.where(painted, fwhms * mask_cfg.growth_factor, 0.0),
            painted.sum())


def star_mask_device(image: torch.Tensor, mask_cfg: StarMaskConfig,
                     max_peaks: Optional[int] = None,
                     scan_cap: Optional[int] = None) -> StarMaskResult:
    """The star mask of ``image`` built on its device: detection
    (capacity ``max_peaks``, None: every candidate), the exact 3 px
    dedupe (``scan_cap`` None: every conflicted candidate), the FWHM
    filter, the paint (K13) and the luminance protection; one fetch of
    the counts. Counters ``stretch.masked.candidates`` (the detection's
    peaks) and ``stretch.masked.stars`` (the stars painted). A plane
    under 3 px a side has no stars: its mask is the protection alone."""
    rows, cols = image.shape
    if rows < 3 or cols < 3:
        mask, coverage = SM._mask_finish(image, torch.zeros_like(image),
                                         mask_cfg.luminance_ceiling,
                                         mask_cfg.luminance_protect)
        return StarMaskResult(mask=mask, stars_masked=0,
                              coverage_fraction=float(coverage))
    packed = SD._detect(image, SD._tile_size(rows, cols),
                        float(mask_cfg.detection_sigma), max_peaks)
    xs, ys, radii, n_masked = _paint_records(packed, mask_cfg, scan_cap)
    mask, coverage = SM._mask_kernel(image, xs, ys, radii, mask_cfg.softness,
                                     mask_cfg.luminance_ceiling,
                                     mask_cfg.luminance_protect)
    n_masked, coverage, candidates = torch.stack([
        n_masked.to(torch.float32), coverage,
        (packed[6] > 0).sum().to(torch.float32)]).tolist()
    trace.count("stretch.masked.candidates", int(candidates))
    trace.count("stretch.masked.stars", int(n_masked))
    return StarMaskResult(mask=mask, stars_masked=int(n_masked),
                          coverage_fraction=coverage)


def masked_stretch(image, config: MaskedStretchConfig = MaskedStretchConfig(),
                   max_peaks: Optional[int] = None,
                   device: Optional[torch.device] = None
                   ) -> MaskedStretchResult:
    """Full masked stretch (masked_stretch.rs:42-123): the star mask of
    ``star_mask_device`` (span ``stretch.masked.mask``), then the MTF
    loop (span ``stretch.masked.mtf``). ``image`` goes to ``device``
    (default: its own device for a tensor, else ``cuda_device()``)."""
    img = as_f32(image, device)
    with trace.span("stretch.masked.mask"):
        mask_result = star_mask_device(img, _mask_config(config), max_peaks)
    with trace.span("stretch.masked.mtf"):
        return masked_stretch_with_mask(img, mask_result, config)


def synthesize_luminance(r, g, b) -> torch.Tensor:
    """BT.709 luminance; non-finite → 0 (masked_stretch.rs:126-152)."""
    rs = torch.where(torch.isfinite(r), r, 0.0)
    gs = torch.where(torch.isfinite(g), g, 0.0)
    bs = torch.where(torch.isfinite(b), b, 0.0)
    return 0.2126 * rs + 0.7152 * gs + 0.0722 * bs


def masked_stretch_rgb_shared(r, g, b, config: MaskedStretchConfig =
                              MaskedStretchConfig(),
                              device: Optional[torch.device] = None
                              ) -> dict:
    """One luminance-derived star mask (``star_mask_device`` on the
    BT.709 luminance; span ``stretch.masked.mask``) drives all three
    channels' MTF loops (span ``stretch.masked.mtf``)."""
    r = as_f32(r, device)
    g, b = as_f32(g, r.device), as_f32(b, r.device)
    with trace.span("stretch.masked.mask"):
        shared = star_mask_device(synthesize_luminance(r, g, b),
                                  _mask_config(config))
    with trace.span("stretch.masked.mtf"):
        out = {c: masked_stretch_with_mask(p, shared, config)
               for c, p in (("r", r), ("g", g), ("b", b))}
    out["shared_mask_coverage"] = shared.coverage_fraction
    out["shared_stars_masked"] = shared.stars_masked
    return out
