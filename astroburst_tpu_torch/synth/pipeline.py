"""Synthetic generation pipeline (counterpart of
astroburst_tpu/synth/pipeline.py).

Reference: src-tauri/src/core/synth/pipeline.rs — generate /
generate_stack (per-frame reseeded noise for stacking fixtures), FITS
and star-catalog export. The planes are made on a device (default
``cuda_device()``) and written through the port's FITS writer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

import torch

from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.synth.noise import (NoiseParams, apply_flat_field,
                                              apply_noise,
                                              generate_flat_field)
from astroburst_tpu_torch.synth.psf import (AiryPsf, GaussianPsf,
                                            MoffatPsf, render_stars)
from astroburst_tpu_torch.synth.star_field import (FieldConfig, Star,
                                                   exponential_disk,
                                                   king_cluster,
                                                   uniform_field)


@dataclass
class SynthConfig:
    field: FieldConfig = dc_field(default_factory=FieldConfig)
    field_type: str = "uniform"   # uniform | king_cluster | exponential_disk
    core_radius: float = 50.0
    tidal_radius: float = 400.0
    scale_length: float = 200.0
    inclination_deg: float = 45.0
    psf_type: str = "gaussian"    # gaussian | moffat | airy
    psf_fwhm: float = 3.0
    moffat_beta: float = 2.5
    airy_lambda_over_d: float = 2.0
    noise: NoiseParams = dc_field(default_factory=NoiseParams)
    apply_vignette: bool = False
    vignette_strength: float = 0.3
    n_frames: int = 1


def _gen_field(config: SynthConfig) -> List[Star]:
    if config.field_type == "king_cluster":
        return king_cluster(config.field, config.core_radius,
                            config.tidal_radius)
    if config.field_type == "exponential_disk":
        return exponential_disk(config.field, config.scale_length,
                                config.inclination_deg)
    return uniform_field(config.field)


def _make_psf(config: SynthConfig):
    if config.psf_type == "moffat":
        return MoffatPsf.from_fwhm(config.psf_fwhm, config.moffat_beta)
    if config.psf_type == "airy":
        return AiryPsf(config.airy_lambda_over_d)
    return GaussianPsf.from_fwhm(config.psf_fwhm)


def _ground_truth(config: SynthConfig, device):
    stars = _gen_field(config)
    gt = render_stars(stars, _make_psf(config), config.field.width,
                      config.field.height, device)
    return gt, stars


def _frame(config: SynthConfig, gt: torch.Tensor, i: int) -> torch.Tensor:
    """Frame i: the flat (seed + 999 + i) when vignetted, then the noise
    (seed + i·7919)."""
    img = gt
    if config.apply_vignette:
        flat = generate_flat_field(config.field.width, config.field.height,
                                   config.noise.seed + 999 + i,
                                   config.vignette_strength, gt.device)
        img = apply_flat_field(img, flat)
    params = dataclasses.replace(config.noise,
                                 seed=config.noise.seed + i * 7919)
    return apply_noise(img, params)


def generate(config: SynthConfig = SynthConfig(),
             device: Optional[torch.device] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, List[Star]]:
    """(noisy, ground_truth, stars) (pipeline.rs:63-85)."""
    gt, stars = _ground_truth(config, device_or_cuda(device))
    return _frame(config, gt, 0), gt, stars


def generate_stack(config: SynthConfig,
                   device: Optional[torch.device] = None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor, List[Star]]:
    """Per-frame reseeded noisy frames over one ground truth
    (pipeline.rs:87-114)."""
    gt, stars = _ground_truth(config, device_or_cuda(device))
    return [_frame(config, gt, i) for i in range(config.n_frames)], gt, stars


def save_fits(image: torch.Tensor, path: str) -> None:
    write_fits_mono(path, image.cpu().numpy())


def save_catalog(stars: List[Star], path: str) -> None:
    lines = ["id,x,y,z,flux,temperature"]
    for i, s in enumerate(stars):
        lines.append(f"{i},{s.x:.4f},{s.y:.4f},{s.z:.4f},{s.flux:.4f},"
                     f"{s.temperature:.1f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
