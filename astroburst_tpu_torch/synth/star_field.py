"""Synthetic star field generators (its own copy of
astroburst_tpu/synth/star_field.py: the same numpy draws, so a seed
gives the same star list bit for bit).

Reference: src-tauri/src/core/synth/star_field.rs — uniform,
King-profile cluster and exponential-disk fields with power-law flux
(α = 2.5). Host numpy with deterministic seeds (star lists are tiny).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Star:
    x: float
    y: float
    z: float
    flux: float
    temperature: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class FieldConfig:
    width: int = 2048
    height: int = 2048
    n_stars: int = 500
    flux_min: float = 100.0
    flux_max: float = 50000.0
    seed: int = 42


def _power_law_flux(rng: np.random.Generator, flux_min: float,
                    flux_max: float, n: int) -> np.ndarray:
    alpha = 2.5
    f_min_inv = flux_min ** (1.0 - alpha)
    f_max_inv = flux_max ** (1.0 - alpha)
    u = rng.random(n)
    return (f_min_inv + u * (f_max_inv - f_min_inv)) ** (1.0 / (1.0 - alpha))


def uniform_field(cfg: FieldConfig) -> List[Star]:
    rng = np.random.default_rng(cfg.seed)
    flux = _power_law_flux(rng, cfg.flux_min, cfg.flux_max, cfg.n_stars)
    xs = rng.random(cfg.n_stars) * cfg.width
    ys = rng.random(cfg.n_stars) * cfg.height
    temps = 3000.0 + rng.random(cfg.n_stars) * 27000.0
    return [Star(float(x), float(y), 0.0, float(f), float(t))
            for x, y, f, t in zip(xs, ys, flux, temps)]


def king_cluster(cfg: FieldConfig, core_radius: float,
                 tidal_radius: float) -> List[Star]:
    """Rejection-sampled King profile (star_field.rs:69-95)."""
    rng = np.random.default_rng(cfg.seed)
    cx, cy = cfg.width * 0.5, cfg.height * 0.5
    c = tidal_radius / core_radius
    king_norm = 1.0 / math.sqrt(1.0 + c * c)
    stars: List[Star] = []
    while len(stars) < cfg.n_stars:
        r = rng.random() * tidal_radius
        profile = max(1.0 / math.sqrt(1.0 + (r / core_radius) ** 2)
                      - king_norm, 0.0) ** 2
        if rng.random() < profile:
            theta = rng.random() * 2.0 * math.pi
            flux = float(_power_law_flux(rng, cfg.flux_min, cfg.flux_max, 1)[0])
            stars.append(Star(cx + r * math.cos(theta),
                              cy + r * math.sin(theta), 0.0, flux,
                              3000.0 + rng.random() * 27000.0))
    return stars


def exponential_disk(cfg: FieldConfig, scale_length: float,
                     inclination_deg: float) -> List[Star]:
    rng = np.random.default_rng(cfg.seed)
    cx, cy = cfg.width * 0.5, cfg.height * 0.5
    cos_i = math.cos(math.radians(inclination_deg))
    u = np.minimum(rng.random(cfg.n_stars), 1.0 - 1e-10)
    r = -scale_length * np.log(1.0 - u)
    theta = rng.random(cfg.n_stars) * 2.0 * math.pi
    flux = _power_law_flux(rng, cfg.flux_min, cfg.flux_max, cfg.n_stars)
    z = rng.random(cfg.n_stars) * scale_length * 0.1
    temps = 3000.0 + rng.random(cfg.n_stars) * 27000.0
    return [Star(float(cx + rr * math.cos(t)),
                 float(cy + rr * math.sin(t) * cos_i), float(zz), float(f),
                 float(tt))
            for rr, t, f, zz, tt in zip(r, theta, flux, z, temps)]
