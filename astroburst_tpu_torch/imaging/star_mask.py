"""Star mask generation (counterpart of astroburst_tpu/imaging/star_mask.py).

Reference: src-tauri/src/core/imaging/star_mask.rs — per-star disks of
radius FWHM·growth with a smoothstep soft edge, max-combined, optional
luminance-ceiling protection, coverage fraction.

The raster is kernel K13 (imaging/star_mask_kernel.py: ``paint_mask``;
its plain version on a CPU tensor). The
luminance protection and the coverage (``_mask_finish``) are the JAX
package's f32 expressions, with the configuration scalars as f32
tensors so that 1 − ceiling rounds as it does there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from astroburst_tpu_torch.analysis.star_detection import detect_stars
from astroburst_tpu_torch.imaging.star_mask_kernel import paint_mask
from astroburst_tpu_torch.runtime.device import as_f32


@dataclass
class StarMaskConfig:
    growth_factor: float = 2.5
    softness: float = 4.0
    detection_sigma: float = 5.0
    min_fwhm: float = 1.5
    max_fwhm: float = 30.0
    luminance_protect: bool = False
    luminance_ceiling: float = 0.85


@dataclass
class StarMaskResult:
    mask: torch.Tensor
    stars_masked: int
    coverage_fraction: float


def _mask_finish(image: torch.Tensor, mask: torch.Tensor,
                 luminance_ceiling: float, luminance_protect: bool):
    """(mask, coverage 0-d f32): the luminance protection of
    star_mask.rs, then the fraction of pixels above 0.01."""
    h, w = image.shape
    if luminance_protect:
        ceiling = torch.tensor(luminance_ceiling, dtype=torch.float32,
                               device=image.device)
        inv_range = torch.where(ceiling < 1.0, 1.0 / (1.0 - ceiling), 1.0)
        excess = torch.clamp((image - ceiling) * inv_range, 0.0, 1.0)
        smooth = excess * excess * (3.0 - 2.0 * excess)
        lum = (image > ceiling) & (mask < 1.0)
        mask = torch.where(lum, torch.maximum(mask, smooth), mask)
    coverage = (mask > 0.01).sum().to(torch.float32) / (h * w)
    return mask, coverage


def _mask_kernel(image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 radii: torch.Tensor, softness: float,
                 luminance_ceiling: float, luminance_protect: bool):
    """Paint (K13) and finish: (mask [h, w] f32, coverage 0-d f32)."""
    h, w = image.shape
    mask = paint_mask(xs, ys, radii, softness, h, w)
    return _mask_finish(image, mask, luminance_ceiling, luminance_protect)


def _star_arrays(detection, config: StarMaskConfig):
    """FWHM-filtered (xs, ys, radii, n_masked) host arrays for the paint
    (star_mask.rs:61-70's per-star loop inputs)."""
    stars = [s for s in detection.stars
             if config.min_fwhm <= s.fwhm <= config.max_fwhm]
    k = max(len(stars), 1)
    xs = np.zeros(k, np.float32)
    ys = np.zeros(k, np.float32)
    radii = np.zeros(k, np.float32)
    for i, s in enumerate(stars):
        xs[i] = s.x
        ys[i] = s.y
        radii[i] = s.fwhm * config.growth_factor
    return xs, ys, radii, len(stars)


def generate_star_mask_from_detection(
        image, detection, config: StarMaskConfig,
        device: Optional[torch.device] = None) -> StarMaskResult:
    """Star mask of ``image`` from a finished detection. ``image`` goes
    to ``device`` (default: its own device for a tensor, else
    ``cuda_device()``); one host fetch (the coverage)."""
    img = as_f32(image, device)
    xs, ys, radii, n_masked = _star_arrays(detection, config)
    mask, coverage = _mask_kernel(
        img, *(torch.from_numpy(a).to(img.device) for a in (xs, ys, radii)),
        config.softness, config.luminance_ceiling, config.luminance_protect)
    return StarMaskResult(mask=mask, stars_masked=n_masked,
                          coverage_fraction=float(coverage))


def generate_star_mask(image, config: StarMaskConfig = StarMaskConfig(),
                       device: Optional[torch.device] = None
                       ) -> StarMaskResult:
    """detect_stars (max_peaks 1024, host dedupe), then the mask."""
    img = as_f32(image, device)
    detection = detect_stars(img, config.detection_sigma)
    return generate_star_mask_from_detection(img, detection, config)
