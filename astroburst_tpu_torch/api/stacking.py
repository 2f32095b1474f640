"""The stacking commands (counterpart of astroburst_tpu/api/stacking.py;
reference: src-tauri/src/cmd/stacking/).

- ``stack`` (combine.rs:77): FITS paths in; the frames decoded into the
  port's image cache on the device, stacked by
  ``stacking.combine.stack_images`` (kernels K1 and K2 in the phase
  correlation, K3 in the shift + clip); ``stacked.fits`` and its
  auto-STF'd ``stacked.png`` out, the result cached under the FITS path.
- ``calibrate`` (combine.rs:17): masters from bias/dark/flat FITS paths
  (``stacking.calibration.create_master_*``), one light calibrated;
  ``<stem>_calibrated.fits`` and its preview out.
- ``run_pipeline_cmd`` (pipeline.rs:71): masters, then per channel
  calibrate → (mean-normalize) → median/MAD sigma-clipped mean →
  min-max normalize (``imaging.calibration_pipeline``, plain torch, no
  kernel); ``master_<label>.fits``, base64 PNG previews encoded in
  memory by ``io/png`` (the card's machine has no Pillow) and, with
  three channels of one shape, ``pipeline_rgb.fits``.
- ``drizzle_stack_cmd`` (drizzle.rs; not registered in the reference):
  ``stacking.drizzle.drizzle_stack`` from FITS paths (K1 and K2 in the
  phase correlation, K7 in the exact finalize); ``drizzled.fits`` and
  its preview out.

Each command takes a keyword-only ``device`` (default
``cuda_device()``), resolved before anything else.
"""

from __future__ import annotations

import base64
import os
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM, Timer,
                                             load_cached, load_cached_many,
                                             png_path_for)
from astroburst_tpu_torch.dtypes import (AlignmentMethod, DrizzleConfig,
                                         DrizzleKernel, ImageStats,
                                         StackConfig)
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.calibration_pipeline import (
    BatchStackConfig, ChannelInput, run_batch_pipeline)
from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
from astroburst_tpu_torch.io import (encode_gray_png, resolve_inputs,
                                     write_fits_mono, write_fits_rgb)
from astroburst_tpu_torch.ops.ipc import nearest_downsample
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir
from astroburst_tpu_torch.runtime.progress import ProgressHandle
from astroburst_tpu_torch.stacking.calibration import (CalibrationConfig,
                                                       calibrate_image,
                                                       create_master_bias,
                                                       create_master_dark,
                                                       create_master_flat)
from astroburst_tpu_torch.stacking.combine import stack_images
from astroburst_tpu_torch.stacking.drizzle import drizzle_stack


def _save_preview(image: torch.Tensor, path: str,
                  stats: ImageStats) -> None:
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def _masters_from_paths(bias_paths, dark_paths, flat_paths,
                        device: torch.device) -> CalibrationConfig:
    bias = create_master_bias(bias_paths, device=device) \
        if bias_paths else None
    dark = create_master_dark(dark_paths, bias, device=device) \
        if dark_paths else None
    flat = create_master_flat(flat_paths, bias, dark, device=device) \
        if flat_paths else None
    return CalibrationConfig(master_bias=bias, master_dark=dark,
                             master_flat=flat)


def _has_masters(masters: CalibrationConfig) -> dict:
    return {C.RES_HAS_BIAS: masters.master_bias is not None,
            C.RES_HAS_DARK: masters.master_dark is not None,
            C.RES_HAS_FLAT: masters.master_flat is not None}


def calibrate(light_path: str, output_dir: str = "",
              bias_paths: Optional[Sequence[str]] = None,
              dark_paths: Optional[Sequence[str]] = None,
              flat_paths: Optional[Sequence[str]] = None,
              dark_exposure_ratio: float = 1.0, *,
              device: Optional[torch.device] = None) -> dict:
    """Calibrate one light frame (combine.rs:17)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(light_path, device)
    masters = _masters_from_paths(bias_paths, dark_paths, flat_paths,
                                  device)
    masters.dark_exposure_ratio = dark_exposure_ratio
    calibrated = calibrate_image(entry.image, masters)
    stats = compute_image_stats(calibrated)

    stem = os.path.splitext(os.path.basename(light_path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_calibrated.fits")
    write_fits_mono(fits_path, calibrated.cpu().numpy(), entry.header)
    png_path = png_path_for(light_path, out_dir, "calibrated")
    _save_preview(calibrated, png_path, stats)
    h, w = calibrated.shape
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        **_has_masters(masters),
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


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


def _png_b64(image: torch.Tensor) -> str:
    """Auto-STF to u8 at full size first, then the 1024 nearest
    downsample (the JAX package's order, not save_stf_preview_png's),
    as a base64 8-bit gray PNG."""
    stats = compute_image_stats(image)
    u8 = nearest_downsample(apply_stf_u8(image, auto_stf(stats), stats),
                            1024)
    return base64.b64encode(encode_gray_png(u8.cpu().numpy())).decode(
        "ascii")


def run_pipeline_cmd(channels: Sequence[dict], output_dir: str = "",
                     bias_paths: Optional[Sequence[str]] = None,
                     dark_paths: Optional[Sequence[str]] = None,
                     flat_paths: Optional[Sequence[str]] = None,
                     sigma_low: float = 2.5, sigma_high: float = 3.0,
                     max_iterations: int = 5,
                     normalize_before_stack: bool = True, *,
                     device: Optional[torch.device] = None) -> dict:
    """masters → calibrate → stack → base64 previews (pipeline.rs:71).
    channels: [{label, lights: [paths]}]."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    masters = _masters_from_paths(bias_paths, dark_paths, flat_paths,
                                  device)
    inputs = []
    for ch in channels:
        lights = [e.image for e in load_cached_many(ch["lights"],
                                                    device=device)]
        inputs.append(ChannelInput(label=ch.get("label", "L"),
                                   lights=lights))
    result = run_batch_pipeline(
        inputs, masters,
        BatchStackConfig(sigma_low=sigma_low, sigma_high=sigma_high,
                         max_iterations=max_iterations,
                         normalize_before_stack=normalize_before_stack))
    channel_out = []
    for label, master in result.master_channels:
        fits_path = os.path.join(out_dir, f"master_{label}.fits")
        write_fits_mono(fits_path, master.cpu().numpy())
        channel_out.append({
            C.RES_LABEL: label,
            C.RES_FITS_PATH: fits_path,
            "preview_b64": _png_b64(master),
        })
    out = {
        C.CHANNELS: channel_out,
        "stats": result.stats,
        **_has_masters(masters),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
    if result.rgb is not None:
        rgb_path = os.path.join(out_dir, "pipeline_rgb.fits")
        r, g, b = result.rgb.cpu().numpy()
        write_fits_rgb(rgb_path, r, g, b)
        out["rgb_fits_path"] = rgb_path
    return out


def drizzle_stack_cmd(paths: Sequence[str], output_dir: str = "",
                      scale: Optional[float] = None,
                      pixfrac: Optional[float] = None,
                      kernel: Optional[str] = None,
                      sigma: Optional[float] = None,
                      sigma_iterations: Optional[int] = None,
                      align: Optional[bool] = None,
                      alignment_method: Optional[str] = None, *,
                      device: Optional[torch.device] = None) -> dict:
    """Drizzle from FITS paths (cmd/stacking/drizzle.rs: present in the
    reference but not registered — kept for API completeness). Offsets
    come back as [dx, dy], dims as [cols, rows]."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entries = load_cached_many(paths, device=device)
    config = DrizzleConfig(
        scale=scale if scale is not None else C.DEFAULT_DRIZZLE_SCALE,
        pixfrac=pixfrac if pixfrac is not None else C.DEFAULT_DRIZZLE_PIXFRAC,
        kernel=DrizzleKernel.parse(kernel),
        sigma_low=sigma if sigma is not None else C.DEFAULT_DRIZZLE_SIGMA,
        sigma_high=sigma if sigma is not None else C.DEFAULT_DRIZZLE_SIGMA,
        sigma_iterations=(sigma_iterations if sigma_iterations is not None
                          else C.DEFAULT_DRIZZLE_SIGMA_ITERS),
        align=align if align is not None else True,
        alignment_method=AlignmentMethod.parse(alignment_method))
    progress = ProgressHandle(C.EVENT_DRIZZLE_RGB_PROGRESS,
                              total=len(paths) + 1)
    result = drizzle_stack([e.image for e in entries], config, progress,
                           device=device)
    stats = compute_image_stats(result.image)
    fits_path = os.path.join(out_dir, "drizzled.fits")
    write_fits_mono(fits_path, result.image.cpu().numpy(),
                    entries[0].header)
    png_path = os.path.join(out_dir, "drizzled.png")
    _save_preview(result.image, png_path, stats)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_INPUT_DIMS: list(result.input_dims[::-1]),
        C.RES_OUTPUT_DIMS: list(result.output_dims[::-1]),
        C.RES_SCALE: result.output_scale,
        C.RES_FRAME_COUNT: result.frame_count,
        C.RES_REJECTED_PIXELS: result.rejected_pixels,
        C.RES_OFFSETS: [[dx, dy] for dx, dy in result.offsets],
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
