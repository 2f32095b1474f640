"""Empirical PSF estimation (counterpart of
astroburst_tpu/imaging/psf_estimation.py).

Reference: src-tauri/src/core/imaging/psf_estimation.rs — detect
candidates, quality-filter (saturation / min-peak / ellipticity /
edge-margin / center-distance), score-rank, take top-N; extract
cutouts → subpixel re-center (bilinear) → normalize → average into an
empirical kernel; moment FWHM/ellipticity per star; spread radius.

Detection is the port's ``detect_stars`` (kernels K10 and K11); the
quality filter and the ranking are host code, as in JAX. The ≤ N
cutouts are one batched gather on the image's device, then each is
recentred, normalized and averaged as ``_cutout_average_kernel``
(psf_estimation.py:78-124) does, with torch's sums in place of XLA's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from astroburst_tpu_torch.analysis.star_detection import detect_stars
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.ops.stats import valid_range
from astroburst_tpu_torch.runtime.device import as_f32


@dataclass
class PsfEstimationConfig:
    num_stars: int = 30
    cutout_radius: int = 15
    saturation_threshold: float = 0.95
    min_peak_fraction: float = 0.10
    max_ellipticity: float = 0.3
    edge_margin: int = 30
    max_center_distance_fraction: float = 0.7
    detection_sigma: float = 5.0


@dataclass
class StarCandidate:
    x: float
    y: float
    peak: float
    flux: float
    fwhm: float
    ellipticity: float
    distance_from_center: float
    snr: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class PsfResult:
    kernel: np.ndarray          # [size, size] f32, sums to 1
    kernel_size: int
    average_fwhm: float
    average_ellipticity: float
    stars_used: List[StarCandidate]
    stars_rejected: int
    spread_pixels: float


def score_star(s: StarCandidate) -> float:
    """Quality score (psf_estimation.rs:509-516)."""
    roundness = 1.0 - s.ellipticity
    snr_score = min(s.snr / 100.0, 1.0)
    center_score = 1.0 / (1.0 + s.distance_from_center / 500.0)
    fwhm_consistency = 1.0 / (1.0 + abs(s.fwhm - 4.0) / 4.0)
    return (roundness * 0.35 + snr_score * 0.30 + center_score * 0.15 +
            fwhm_consistency * 0.20)


def _take(x: torch.Tensor, shift: torch.Tensor, off: int,
          dim: int) -> torch.Tensor:
    """[n, s, s] rows (dim 1) or columns (dim 2) of each cutout at
    clamp(i + shift + off, 0, s − 1), shift per cutout."""
    n, size = x.shape[0], x.shape[1]
    ar = torch.arange(size, device=x.device)
    idx = torch.clamp(ar[None, :] + shift[:, None] + off, 0, size - 1)
    idx = idx[:, :, None] if dim == 1 else idx[:, None, :]
    return torch.gather(x, dim, idx.expand(n, size, size))


def _cutout_average(image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    radius: int):
    """(psf [size, size], spread 0-d): the cutouts around (ys, xs) in one
    gather, non-finite → 0, each shifted bilinearly so that its weighted
    centroid lands on the centre, normalized to unit sum, averaged and
    normalized again; the spread is the PSF's RMS radius."""
    size = radius * 2 + 1
    dev = image.device
    ar = torch.arange(size, device=dev)
    iy = torch.round(ys).to(torch.int64)
    ix = torch.round(xs).to(torch.int64)
    y0 = torch.clamp(iy - radius, 0, image.shape[0] - size)
    x0 = torch.clamp(ix - radius, 0, image.shape[1] - size)
    cut = image[(y0[:, None] + ar[None, :])[:, :, None],
                (x0[:, None] + ar[None, :])[:, None, :]]
    cut = torch.where(torch.isfinite(cut), cut, 0.0)
    grid = ar.to(torch.float32)
    w = torch.clamp(cut.sum(dim=(1, 2)), min=1e-30)
    cy = (grid[None, :, None] * cut).sum(dim=(1, 2)) / w
    cx = (grid[None, None, :] * cut).sum(dim=(1, 2)) / w
    target = (size - 1) / 2.0
    dy = cy - target
    dx = cx - target
    ky = torch.floor(dy)
    kx = torch.floor(dx)
    fy = (dy - ky)[:, None, None]
    fx = (dx - kx)[:, None, None]
    ky, kx = ky.to(torch.int64), kx.to(torch.int64)
    t0 = _take(cut, ky, 0, 1) * (1 - fy) + _take(cut, ky, 1, 1) * fy
    shifted = _take(t0, kx, 0, 2) * (1 - fx) + _take(t0, kx, 1, 2) * fx
    s = shifted.sum(dim=(1, 2))[:, None, None]
    normalized = torch.where(s > 0, shifted / torch.clamp(s, min=1e-30),
                             shifted)
    count = max(float(xs.shape[0]), 1.0)
    avg = normalized.sum(dim=0) / count
    total = avg.sum()
    psf = torch.where(total > 0, avg / torch.clamp(total, min=1e-30), avg)
    yy = grid[:, None] - target
    xx = grid[None, :] - target
    wsum = torch.clamp(psf.sum(), min=1e-30)
    spread = torch.sqrt(((yy * yy + xx * xx) * psf).sum() / wsum)
    return psf, spread


def estimate_psf(image, config: PsfEstimationConfig = PsfEstimationConfig()
                 ) -> PsfResult:
    """The empirical PSF of ``image`` on its device (a tensor's own,
    else ``cuda_device()``)."""
    img = as_f32(image)
    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    max_dist = float(np.hypot(cx, cy)) * config.max_center_distance_fraction

    data_max = valid_range(img)[1]    # compute_image_stats(img).max
    det = detect_stars(img, config.detection_sigma)
    if not det.stars:
        raise InvalidInput("No stars detected in image")

    candidates: List[StarCandidate] = []
    for s in det.stars:
        dist = float(np.hypot(s.x - cx, s.y - cy))
        cand = StarCandidate(x=s.x, y=s.y, peak=s.peak, flux=s.flux,
                             fwhm=s.fwhm, ellipticity=s.eccentricity,
                             distance_from_center=dist, snr=s.snr)
        norm_peak = s.peak / max(data_max, 1e-30)
        in_bounds = (config.edge_margin <= s.x < w - config.edge_margin and
                     config.edge_margin <= s.y < h - config.edge_margin)
        if (in_bounds and norm_peak < config.saturation_threshold and
                norm_peak > config.min_peak_fraction and
                cand.ellipticity < config.max_ellipticity and
                dist < max_dist):
            candidates.append(cand)

    if not candidates:
        raise InvalidInput("No stars passed quality filters")

    candidates.sort(key=score_star, reverse=True)
    selected = candidates[:config.num_stars]

    n = len(selected)
    pos = torch.tensor([[s.x for s in selected], [s.y for s in selected]],
                       dtype=torch.float32).to(img.device)
    psf, spread = _cutout_average(img, pos[0], pos[1], config.cutout_radius)
    kernel = torch.cat([psf.reshape(-1), spread[None]]).cpu().numpy()
    size = config.cutout_radius * 2 + 1
    return PsfResult(
        kernel=kernel[:-1].reshape(size, size),
        kernel_size=size,
        average_fwhm=float(np.mean([s.fwhm for s in selected])),
        average_ellipticity=float(np.mean([s.ellipticity for s in selected])),
        stars_used=selected,
        stars_rejected=len(candidates) - n,
        spread_pixels=float(kernel[-1]))


def psf_to_kernel(psf: PsfResult) -> np.ndarray:
    """Normalized kernel array for deconvolution (psf_estimation.rs:136)."""
    k = np.asarray(psf.kernel, np.float32)
    s = k.sum()
    return k / s if s > 0 else k
