"""Processing commands (counterpart of astroburst_tpu/api/processing.py;
reference: src-tauri/src/cmd/processing/).

Ported so far: ``resample_fits_cmd`` (the bicubic resize with its WCS
rescale, ``imaging.resample``). The rest of the JAX module waits for
its queue items: the stretch, tone and wavelet commands for A11, the
background extraction for A9, the deconvolution for A13.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM, Timer,
                                             load_cached, png_path_for)
from astroburst_tpu_torch.imaging.resample import resample_with_wcs
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir


def _auto_preview(image: torch.Tensor, path: str) -> None:
    stats = compute_image_stats(image)
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def resample_fits_cmd(path: str, output_dir: str, target_width: int,
                      target_height: int, *,
                      device: Optional[torch.device] = None) -> dict:
    """Bicubic resize + WCS rescale (cmd/processing/resample.rs:12)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    result = resample_with_wcs(entry.image, entry.header or HduHeader(),
                               target_height, target_width)
    header = entry.header.copy() if entry.header else None
    if header is not None:
        for k, v in result.header_updates:
            if k not in ("NAXIS1", "NAXIS2"):
                header.set_f64(k, v)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_{C.RESAMPLED}.fits")
    write_fits_mono(fits_path, result.image.cpu().numpy(), header)
    png_path = png_path_for(path, out_dir, C.RESAMPLED)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ORIGINAL_DIMENSIONS: list(result.original_dims[::-1]),
        C.RES_DIMENSIONS: [target_width, target_height],
        C.RES_WCS_UPDATES: dict(result.header_updates),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
