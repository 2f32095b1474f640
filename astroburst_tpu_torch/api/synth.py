"""Synth commands (counterpart of astroburst_tpu/api/synth.py;
reference: src-tauri/src/cmd/synth.rs).

The planes are rendered and noised on ``device`` (``cuda_device()``
when None, which raises where there is no card), fetched once each and
written as FITS; the single frame's preview goes through
``compute_image_stats`` → ``auto_stf`` → the STF u8 preview. Two calls
with the same seeds write the same bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import MAX_PREVIEW_DIM, Timer
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir
from astroburst_tpu_torch.synth import (FieldConfig, NoiseParams, SynthConfig,
                                        generate, generate_stack,
                                        save_catalog)
from astroburst_tpu_torch.synth.pipeline import save_fits


def _build_config(width, height, n_stars, seed, field_type, psf_type,
                  psf_fwhm, noise_seed, apply_vignette, n_frames
                  ) -> SynthConfig:
    return SynthConfig(
        field=FieldConfig(width=width or 2048, height=height or 2048,
                          n_stars=n_stars or 500, seed=seed or 42),
        field_type=field_type or "uniform",
        psf_type=psf_type or "gaussian",
        psf_fwhm=psf_fwhm or 3.0,
        noise=NoiseParams(seed=noise_seed or 123),
        apply_vignette=bool(apply_vignette),
        n_frames=n_frames or 1)


def generate_synth_cmd(output_dir: str = "", width: Optional[int] = None,
                       height: Optional[int] = None,
                       n_stars: Optional[int] = None,
                       seed: Optional[int] = None,
                       field_type: Optional[str] = None,
                       psf_type: Optional[str] = None,
                       psf_fwhm: Optional[float] = None,
                       noise_seed: Optional[int] = None,
                       apply_vignette: Optional[bool] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """cmd/synth.rs:17 — one synthetic frame + catalog + preview."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    config = _build_config(width, height, n_stars, seed, field_type,
                           psf_type, psf_fwhm, noise_seed, apply_vignette, 1)
    noisy, _ground_truth, stars = generate(config, device)
    fits_path = os.path.join(out_dir, "synth.fits")
    save_fits(noisy, fits_path)
    catalog_path = os.path.join(out_dir, "synth_catalog.csv")
    save_catalog(stars, catalog_path)
    stats = compute_image_stats(noisy)
    png_path = os.path.join(out_dir, "synth.png")
    helpers.save_stf_preview_png(noisy, auto_stf(stats), stats,
                                 png_path, MAX_PREVIEW_DIM)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        "catalog_path": catalog_path,
        C.RES_WIDTH: config.field.width,
        C.RES_HEIGHT: config.field.height,
        "star_count": len(stars),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def generate_synth_stack_cmd(output_dir: str = "",
                             n_frames: Optional[int] = None,
                             width: Optional[int] = None,
                             height: Optional[int] = None,
                             n_stars: Optional[int] = None,
                             seed: Optional[int] = None,
                             field_type: Optional[str] = None,
                             psf_type: Optional[str] = None,
                             psf_fwhm: Optional[float] = None,
                             noise_seed: Optional[int] = None,
                             apply_vignette: Optional[bool] = None, *,
                             device: Optional[torch.device] = None) -> dict:
    """cmd/synth.rs:58 — frame stack for calibration/alignment fixtures."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    config = _build_config(width, height, n_stars, seed, field_type,
                           psf_type, psf_fwhm, noise_seed, apply_vignette,
                           n_frames or 5)
    frames, ground_truth, stars = generate_stack(config, device)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(out_dir, f"synth_frame_{i:03}.fits")
        save_fits(frame, p)
        paths.append(p)
    gt_path = os.path.join(out_dir, "synth_ground_truth.fits")
    save_fits(ground_truth, gt_path)
    catalog_path = os.path.join(out_dir, "synth_catalog.csv")
    save_catalog(stars, catalog_path)
    return {
        C.RES_FRAMES: paths,
        C.RES_FRAME_COUNT: len(paths),
        "ground_truth_path": gt_path,
        "catalog_path": catalog_path,
        "star_count": len(stars),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
