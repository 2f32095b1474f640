"""Subframe selector metrics (counterpart of
astroburst_tpu/analysis/subframe.py).

Reference: src-tauri/src/core/analysis/subframe.rs — per-frame star
metrics (count, median FWHM/eccentricity/SNR, noise ratio), weighted
quality score, accept/reject thresholds, max-normalized weights. Host
code over the port's ``detect_stars`` (kernels K10 and K11), one host
fetch a frame.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Sequence

from astroburst_tpu_torch.analysis.star_detection import detect_stars

DETECTION_SIGMA = 4.0
MIN_STARS_FOR_METRICS = 5


@dataclass
class SubframeWeightConfig:
    fwhm_weight: float = 1.0
    eccentricity_weight: float = 0.5
    snr_weight: float = 1.0
    noise_weight: float = 0.3
    max_fwhm: float = 8.0
    max_eccentricity: float = 0.7
    min_snr: float = 5.0
    min_stars: int = 5


@dataclass
class SubframeMetrics:
    file_path: str
    file_name: str
    star_count: int
    median_fwhm: float
    median_eccentricity: float
    median_snr: float
    background_median: float
    background_sigma: float
    noise_ratio: float
    weight: float
    accepted: bool

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def _median_of(values: Sequence[float]) -> float:
    vals = sorted(v for v in values if math.isfinite(v))
    if not vals:
        return 0.0
    mid = len(vals) // 2
    if len(vals) % 2 == 0:
        return (vals[mid - 1] + vals[mid]) / 2.0
    return vals[mid]


def compute_weight(fwhm: float, ecc: float, snr: float, noise: float,
                   config: SubframeWeightConfig) -> float:
    """subframe.rs:113-135."""
    fwhm_score = 1.0 / fwhm if fwhm > 0.5 else 0.0
    ecc_score = 1.0 - ecc
    snr_score = max(math.log(snr), 0.0) if snr > 0 else 0.0
    noise_score = 1.0 / (1.0 + noise * 10.0)
    total = (config.fwhm_weight + config.eccentricity_weight +
             config.snr_weight + config.noise_weight)
    if total < 1e-15:
        return 0.0
    raw = (config.fwhm_weight * fwhm_score +
           config.eccentricity_weight * ecc_score +
           config.snr_weight * snr_score +
           config.noise_weight * noise_score)
    return max(raw / total, 0.0)


def analyze_subframe(image, file_path: str,
                     config: SubframeWeightConfig = SubframeWeightConfig()
                     ) -> SubframeMetrics:
    """The metrics of one frame, detected on its device (a tensor's
    own, else ``cuda_device()``)."""
    file_name = os.path.basename(file_path) or file_path
    result = detect_stars(image, DETECTION_SIGMA)
    stars = result.stars

    if len(stars) < min(MIN_STARS_FOR_METRICS, config.min_stars):
        return SubframeMetrics(
            file_path=file_path, file_name=file_name, star_count=len(stars),
            median_fwhm=0.0, median_eccentricity=0.0, median_snr=0.0,
            background_median=result.background_median,
            background_sigma=result.background_sigma,
            noise_ratio=0.0, weight=0.0, accepted=False)

    median_fwhm = _median_of([s.fwhm for s in stars])
    median_ecc = _median_of([s.eccentricity for s in stars])
    median_snr = _median_of([s.snr for s in stars])
    noise_ratio = (result.background_sigma / result.background_median
                   if result.background_median > 1e-15 else 0.0)
    weight = compute_weight(median_fwhm, median_ecc, median_snr, noise_ratio,
                            config)
    accepted = (len(stars) >= config.min_stars and
                median_fwhm <= config.max_fwhm and
                median_ecc <= config.max_eccentricity and
                median_snr >= config.min_snr)
    return SubframeMetrics(
        file_path=file_path, file_name=file_name, star_count=len(stars),
        median_fwhm=median_fwhm, median_eccentricity=median_ecc,
        median_snr=median_snr,
        background_median=result.background_median,
        background_sigma=result.background_sigma,
        noise_ratio=noise_ratio, weight=weight, accepted=accepted)


def normalize_weights(metrics: List[SubframeMetrics]) -> None:
    """Max-normalize in place (subframe.rs:138-149)."""
    max_w = max((m.weight for m in metrics), default=0.0)
    if max_w > 1e-15:
        for m in metrics:
            m.weight /= max_w
