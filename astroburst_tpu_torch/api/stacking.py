"""The ``stack`` command (counterpart of astroburst_tpu/api/stacking.py
:stack; reference: src-tauri/src/cmd/stacking/combine.rs:77).

FITS paths in; the frames decoded into the port's image cache on the
device, stacked by ``stacking.combine.stack_images`` (kernels K1 and K2
in the phase correlation, K3 in the shift + clip); ``stacked.fits``
and its auto-STF'd ``stacked.png`` out, the result cached under the
FITS path. The other stacking commands of the JAX module (calibrate,
drizzle_stack_cmd, run_pipeline_cmd) are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM, Timer,
                                             load_cached_many)
from astroburst_tpu_torch.dtypes import ImageStats, StackConfig
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io import resolve_inputs, write_fits_mono
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir
from astroburst_tpu_torch.runtime.progress import ProgressHandle
from astroburst_tpu_torch.stacking.combine import stack_images


def _save_preview(image: torch.Tensor, path: str,
                  stats: ImageStats) -> None:
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def stack(paths: Sequence[str], output_dir: str = "",
          sigma_low: Optional[float] = None,
          sigma_high: Optional[float] = None,
          max_iterations: Optional[int] = None,
          align: Optional[bool] = None, *,
          device: Optional[torch.device] = None) -> dict:
    """Sigma-clip stack with alignment (combine.rs:77): the arguments,
    defaults and response keys of the JAX command, on ``device``
    (default ``cuda_device()``). One path is resolved as a directory,
    ZIP or single file."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    if len(paths) == 1:
        paths = resolve_inputs(paths[0])
    if not paths:
        raise InvalidInput("No frames to stack")
    entries = load_cached_many(paths, device=device)
    config = StackConfig(
        sigma_low=sigma_low if sigma_low is not None else 3.0,
        sigma_high=sigma_high if sigma_high is not None else 3.0,
        max_iterations=max_iterations if max_iterations is not None else 5,
        align=align if align is not None else True)
    progress = ProgressHandle(C.EVENT_STACK_PROGRESS, total=len(paths) + 1)
    result = stack_images([e.image for e in entries], config, progress,
                          device)
    stats = compute_image_stats(result.image)

    fits_path = os.path.join(out_dir, "stacked.fits")
    write_fits_mono(fits_path, result.image.cpu().numpy(),
                    entries[0].header)
    png_path = os.path.join(out_dir, "stacked.png")
    _save_preview(result.image, png_path, stats)
    h, w = result.image.shape
    GLOBAL_IMAGE_CACHE.insert(fits_path, result.image, stats=stats,
                              header=entries[0].header)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        C.RES_FRAME_COUNT: result.frame_count,
        C.RES_REJECTED_PIXELS: result.rejected_pixels,
        C.RES_OFFSETS: [[dy, dx] for dy, dx in result.offsets],
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
