"""CCD noise model and flat fields (counterpart of
astroburst_tpu/synth/noise.py).

Reference: src-tauri/src/core/synth/noise.rs — Poisson shot noise on
(signal + sky)·gain·t + dark·t electrons, Gaussian read noise, bias
pedestal, gain division; vignetted flat field with 1% pixel noise.

The draws come from an explicit ``torch.Generator`` on the plane's
device, seeded from ``NoiseParams.seed`` (the flat field from its own
seed): ``torch.poisson`` for the photon electrons, then the normal
read noise. The JAX package draws from ``jax.random``; torch cannot
reproduce those streams, so the two packages agree in distribution,
not draw for draw (ROADMAP C29). The deterministic parts are functions
of the draws (``signal_electrons``, ``noise_transform``,
``flat_from_uniform``), held exactly to numpy in the tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

f32 = np.float32


@dataclass
class NoiseParams:
    gain: float = 1.5
    readout_noise: float = 8.0
    sky_background: float = 200.0
    dark_current: float = 0.05
    exposure_time: float = 300.0
    bias_level: float = 1000.0
    seed: int = 123


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def signal_electrons(image: torch.Tensor, p: NoiseParams) -> torch.Tensor:
    """max((image + sky)·gain·t + dark·t, 0), each operation in f32."""
    dark_t = float(f32(p.dark_current) * f32(p.exposure_time))
    e = (image + float(f32(p.sky_background))) * float(f32(p.gain)) \
        * float(f32(p.exposure_time)) + dark_t
    return torch.clamp(e, min=0.0)


def noise_transform(photon_e: torch.Tensor, read_normal: torch.Tensor,
                    p: NoiseParams) -> torch.Tensor:
    """max((photon_e + normal·readout + bias) / gain, 0) in f32."""
    read_e = read_normal * float(f32(p.readout_noise))
    return torch.clamp((photon_e + read_e + float(f32(p.bias_level)))
                       / float(f32(p.gain)), min=0.0)


def apply_noise(image: torch.Tensor,
                params: NoiseParams = NoiseParams()) -> torch.Tensor:
    """Shot, read and bias noise on ``image``'s device."""
    gen = _generator(params.seed, image.device)
    photon_e = torch.poisson(signal_electrons(image, params), generator=gen)
    read = torch.randn(image.shape, generator=gen, dtype=torch.float32,
                       device=image.device)
    return noise_transform(photon_e, read, params)


def flat_from_uniform(u: torch.Tensor, vignette_strength: float
                      ) -> torch.Tensor:
    """max((1 − s·r²)·(1 + 0.02·u − 0.01), 0.01) for uniform draws ``u``
    [H, W], r the distance from the centre over the half-diagonal."""
    height, width = u.shape
    cx, cy = width * 0.5, height * 0.5
    max_r = float(np.sqrt(f32(cx * cx + cy * cy)))
    yy = torch.arange(height, dtype=torch.float32, device=u.device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=u.device)[None, :]
    r = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / max_r
    pix_noise = 1.0 + u * 0.02 - 0.01
    return torch.clamp((1.0 - float(f32(vignette_strength)) * r * r)
                       * pix_noise, min=0.01)


def generate_flat_field(width: int, height: int, seed: int,
                        vignette_strength: float,
                        device: torch.device) -> torch.Tensor:
    u = torch.rand((height, width), generator=_generator(seed, device),
                   dtype=torch.float32, device=device)
    return flat_from_uniform(u, vignette_strength)


def apply_flat_field(image: torch.Tensor, flat: torch.Tensor
                     ) -> torch.Tensor:
    ok = flat > 1e-6
    return torch.where(ok, image / torch.where(ok, flat, 1.0), image)
