"""PSF command (counterpart of astroburst_tpu/api/psf.py; reference:
src-tauri/src/cmd/psf.rs): the empirical PSF of a file, through the
port's star detection (kernels K10 and K11)."""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api.common import Timer, load_cached
from astroburst_tpu_torch.imaging.psf_estimation import (PsfEstimationConfig,
                                                         estimate_psf)
from astroburst_tpu_torch.runtime.device import device_or_cuda


def estimate_psf_cmd(path: str, num_stars: Optional[int] = None,
                     cutout_radius: Optional[int] = None,
                     saturation_threshold: Optional[float] = None,
                     min_peak_fraction: Optional[float] = None,
                     max_ellipticity: Optional[float] = None, *,
                     device: Optional[torch.device] = None) -> dict:
    """cmd/psf.rs:14 — empirical PSF estimation."""
    t0 = Timer()
    entry = load_cached(path, device_or_cuda(device))
    config = PsfEstimationConfig(
        num_stars=num_stars if num_stars is not None else 30,
        cutout_radius=cutout_radius if cutout_radius is not None else 15,
        saturation_threshold=(saturation_threshold
                              if saturation_threshold is not None else 0.95),
        min_peak_fraction=(min_peak_fraction
                           if min_peak_fraction is not None else 0.10),
        max_ellipticity=(max_ellipticity
                         if max_ellipticity is not None else 0.3))
    result = estimate_psf(entry.image, config)
    return {
        C.RES_KERNEL: result.kernel.tolist(),
        C.RES_KERNEL_SIZE: result.kernel_size,
        C.RES_AVERAGE_FWHM: result.average_fwhm,
        C.RES_AVERAGE_ELLIPTICITY: result.average_ellipticity,
        C.RES_STARS_USED: [s.to_dict() for s in result.stars_used],
        C.RES_STARS_REJECTED: result.stars_rejected,
        C.RES_SPREAD_PIXELS: result.spread_pixels,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
