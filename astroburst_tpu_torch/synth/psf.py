"""PSF renderers: Gaussian / Moffat / Airy (counterpart of
astroburst_tpu/synth/psf.py).

Reference: src-tauri/src/core/synth/psf.rs. Each star is painted into
a fixed window around its rounded centre, its flux normalized over the
window's in-image pixels, as the reference does. The JAX package paints
the stars one at a time in a ``fori_loop``; here every window is
evaluated in one batch, and the contributions are summed per target
pixel deterministically: a stable sort by pixel keeps each pixel's
contributions in star order, and ``torch.segment_reduce`` over [n, 1]
values walks each pixel's run in that order (one thread per pixel, no
atomics; ``index_add_`` would add atomically, in an order that varies
from run to run on the card). So the sums are those of the star-by-star
painting, and the same bits every run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch

from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.synth.star_field import Star

FWHM_TO_SIGMA = 2.3548


@dataclass(frozen=True)
class GaussianPsf:
    sigma: float

    @staticmethod
    def from_fwhm(fwhm: float) -> "GaussianPsf":
        return GaussianPsf(sigma=fwhm / FWHM_TO_SIGMA)

    def radius(self) -> float:
        return self.sigma * 4.0

    def evaluate(self, d2: torch.Tensor) -> torch.Tensor:
        return torch.exp(-d2 / (2.0 * self.sigma * self.sigma))


@dataclass(frozen=True)
class MoffatPsf:
    alpha: float
    beta: float

    @staticmethod
    def from_fwhm(fwhm: float, beta: float) -> "MoffatPsf":
        alpha = fwhm / (2.0 * math.sqrt(2.0 ** (1.0 / beta) - 1.0))
        return MoffatPsf(alpha=alpha, beta=beta)

    def radius(self) -> float:
        return self.alpha * 5.0

    def evaluate(self, d2: torch.Tensor) -> torch.Tensor:
        return torch.pow(1.0 + d2 / (self.alpha * self.alpha), -self.beta)


def _bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Polynomial J1 approximation (psf.rs:100-121, Numerical Recipes)."""
    ax = torch.abs(x)
    y_small = x * x
    num = x * (72362614232.0 + y_small * (-7895059235.0 + y_small *
               (242396853.1 + y_small * (-2972611.439 + y_small *
                (15704.4826 + y_small * (-30.16036606))))))
    den = (144725228442.0 + y_small * (2300535178.0 + y_small *
           (18583304.74 + y_small * (99447.43394 + y_small *
            (376.9991397 + y_small)))))
    small = num / den
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y_big = z * z
    xx = ax - 2.356194491
    p = 1.0 + y_big * (0.183105e-2 + y_big * (-0.3516396496e-4 + y_big *
                       (0.2457520174e-5 + y_big * (-0.240337019e-6))))
    q = (0.04687499995 + y_big * (-0.2002690873e-3 + y_big *
         (0.8449199096e-5 + y_big * (-0.88228987e-6 + y_big *
          0.105787412e-6))))
    big = (0.5641895835 / torch.sqrt(torch.clamp(ax, min=1e-30))) * (
        torch.cos(xx) * p - z * torch.sin(xx) * q)
    big = torch.where(x < 0, -big, big)
    return torch.where(ax < 8.0, small, big)


@dataclass(frozen=True)
class AiryPsf:
    lambda_over_d: float

    def radius(self) -> float:
        return self.lambda_over_d * 4.0

    def evaluate(self, d2: torch.Tensor) -> torch.Tensor:
        r = torch.sqrt(d2)
        x = r * (math.pi / self.lambda_over_d)
        v = 2.0 * _bessel_j1(x) / torch.clamp(x, min=1e-30)
        return torch.where(r < 1e-10, 1.0, v * v)


def render_stars(stars: List[Star], psf, width: int, height: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Flux-normalized windowed star painting (psf.rs:123-170) into an
    f32 [height, width] plane on ``device`` (default ``cuda_device()``)."""
    device = device_or_cuda(device)
    img = torch.zeros(height * width, dtype=torch.float32, device=device)
    if not stars:
        return img.reshape(height, width)
    half = int(math.ceil(psf.radius()))
    window = 2 * half + 1
    xs, ys, fluxes = torch.tensor(
        [[s.x for s in stars], [s.y for s in stars],
         [s.flux for s in stars]], dtype=torch.float32).to(device)
    w = torch.arange(window, device=device)
    # each window's top-left in image coordinates, clamped as the JAX
    # package clamps it on its plane padded by ``window``
    oy = torch.clamp(torch.round(ys).to(torch.int64) - half + window, 0,
                     height + window) - window
    ox = torch.clamp(torch.round(xs).to(torch.int64) - half + window, 0,
                     width + window) - window
    iy = (oy[:, None] + w)[:, :, None]                 # [N, window, 1]
    ix = (ox[:, None] + w)[:, None, :]                 # [N, 1, window]
    py, px = iy.to(torch.float32), ix.to(torch.float32)
    d2 = (px - xs[:, None, None]) ** 2 + (py - ys[:, None, None]) ** 2
    inside = (iy >= 0) & (iy <= height - 1) & (ix >= 0) & (ix <= width - 1)
    vals = torch.where(inside, psf.evaluate(d2), 0.0)
    total = vals.sum(dim=(1, 2))
    norm = torch.where(total > 1e-20,
                       fluxes / torch.clamp(total, min=1e-30), 0.0)
    contrib = (vals * norm[:, None, None])[inside]     # star-major order
    target = (iy * width + ix).expand_as(inside)[inside]
    target, order = torch.sort(target, stable=True)
    pixels, counts = torch.unique_consecutive(target, return_counts=True)
    sums = torch.segment_reduce(contrib[order][:, None], "sum",
                                lengths=counts)
    img[pixels] = sums[:, 0]
    return img.reshape(height, width)
