"""WCS transforms: TAN/SIN/ARC/CAR projections, pixel↔world (its own
copy of astroburst_tpu/astrometry/wcs.py).

Reference: src-tauri/src/core/astrometry/wcs.rs — CRPIX/CRVAL/CD
(CDELT+CROTA2 fallback), single + batch transforms, pixel scale, FOV.
Host f64 numpy, as in the JAX package: catalog math on at most a few
hundred points, which would gain nothing on the card and cost a round
trip. Every expression keeps the JAX module's order, so the results are
bit-equal to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.io.header import HduHeader


@dataclass(frozen=True)
class CelestialCoord:
    ra: float
    dec: float

    def __str__(self) -> str:  # wcs.rs:33-52 display format
        ra_h = self.ra / 15.0
        h = int(ra_h)
        m = int((ra_h - h) * 60.0)
        s = (ra_h - h) * 3600.0 - m * 60.0
        sign = "+" if self.dec >= 0 else "-"
        dec_abs = abs(self.dec)
        d = int(dec_abs)
        dm = int((dec_abs - d) * 60.0)
        ds = (dec_abs - d) * 3600.0 - dm * 60.0
        return f"{h:02d}h{m:02d}m{s:05.2f}s {sign}{d}°{dm:02d}'{ds:05.2f}\""


class WcsTransform:
    def __init__(self, crpix1: float, crpix2: float, crval1: float,
                 crval2: float, cd: np.ndarray, projection: str):
        self.crpix1 = crpix1
        self.crpix2 = crpix2
        self.crval1 = crval1
        self.crval2 = crval2
        self.cd = np.asarray(cd, np.float64).reshape(2, 2)
        self.projection = projection
        dec0 = math.radians(crval2)
        self.sin_dec0 = math.sin(dec0)
        self.cos_dec0 = math.cos(dec0)
        self.ra0_rad = math.radians(crval1)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_header(header: HduHeader) -> "WcsTransform":
        def req(key):
            v = header.get_f64(key)
            if v is None:
                raise InvalidInput(f"Missing {key}")
            return v

        crpix1, crpix2 = req("CRPIX1"), req("CRPIX2")
        crval1, crval2 = req("CRVAL1"), req("CRVAL2")
        cd = WcsTransform._read_cd(header)
        proj = WcsTransform._detect_projection(header)
        return WcsTransform(crpix1, crpix2, crval1, crval2, cd, proj)

    @staticmethod
    def _read_cd(header: HduHeader) -> np.ndarray:
        cds = [header.get_f64(k) for k in ("CD1_1", "CD1_2", "CD2_1",
                                           "CD2_2")]
        if all(v is not None for v in cds):
            return np.array([[cds[0], cds[1]], [cds[2], cds[3]]])
        cdelt1 = header.get_f64("CDELT1")
        cdelt2 = header.get_f64("CDELT2")
        if cdelt1 is None or cdelt2 is None:
            raise InvalidInput("Missing CD matrix and CDELT1/CDELT2")
        theta = math.radians(header.get_f64("CROTA2") or 0.0)
        ct, st = math.cos(theta), math.sin(theta)
        return np.array([[cdelt1 * ct, -cdelt2 * st],
                         [cdelt1 * st, cdelt2 * ct]])

    @staticmethod
    def _detect_projection(header: HduHeader) -> str:
        ctype1 = header.get("CTYPE1") or ""
        suffix = ctype1.rsplit("-", 1)[-1] if "-" in ctype1 else "TAN"
        return suffix if suffix in ("TAN", "SIN", "ARC", "CAR") else "TAN"

    def raw_params(self):
        return (self.crpix1, self.crpix2, self.crval1, self.crval2,
                self.cd.tolist(), self.projection)

    # -- transforms (vectorized; scalars pass through) --------------------------

    def pixel_to_world_batch(self, xs, ys) -> Tuple[np.ndarray, np.ndarray]:
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        dx = xs - self.crpix1 + 1.0
        dy = ys - self.crpix2 + 1.0
        xi = math.radians(1.0) * (self.cd[0, 0] * dx + self.cd[0, 1] * dy)
        eta = math.radians(1.0) * (self.cd[1, 0] * dx + self.cd[1, 1] * dy)
        p = self.projection
        s0, c0 = self.sin_dec0, self.cos_dec0
        if p == "TAN":
            denom = c0 - eta * s0
            ra = self.ra0_rad + np.arctan2(xi, denom)
            dec = np.arctan2(s0 + eta * c0, np.sqrt(xi * xi + denom * denom))
        elif p == "SIN":
            cos_c = np.sqrt(np.maximum(1.0 - xi * xi - eta * eta, 0.0))
            dec = np.arcsin(np.clip(cos_c * s0 + eta * c0, -1, 1))
            ra = self.ra0_rad + np.arctan2(xi, cos_c * c0 - eta * s0)
        elif p == "ARC":
            rho = np.sqrt(xi * xi + eta * eta)
            safe = np.maximum(rho, 1e-15)
            c = rho
            dec = np.arcsin(np.clip(
                np.cos(c) * s0 + (eta / safe) * np.sin(c) * c0, -1, 1))
            ra = self.ra0_rad + np.arctan2(
                xi * np.sin(c), safe * c0 * np.cos(c) - eta * s0 * np.sin(c))
            dec = np.where(rho < 1e-15, math.radians(self.crval2), dec)
            ra = np.where(rho < 1e-15, self.ra0_rad, ra)
        else:  # CAR
            ra = self.ra0_rad + xi / c0
            dec = math.radians(self.crval2) + eta
        ra_deg = np.degrees(ra) % 360.0
        return ra_deg, np.degrees(dec)

    def pixel_to_world(self, x: float, y: float) -> CelestialCoord:
        ra, dec = self.pixel_to_world_batch(np.array([x]), np.array([y]))
        return CelestialCoord(float(ra[0]), float(dec[0]))

    def world_to_pixel_batch(self, ras, decs) -> Tuple[np.ndarray, np.ndarray]:
        ra_r = np.radians(np.asarray(ras, np.float64))
        dec_r = np.radians(np.asarray(decs, np.float64))
        dra = ra_r - self.ra0_rad
        s0, c0 = self.sin_dec0, self.cos_dec0
        sd, cd_ = np.sin(dec_r), np.cos(dec_r)
        cdr, sdr = np.cos(dra), np.sin(dra)
        p = self.projection
        if p == "TAN":
            denom = sd * s0 + cd_ * c0 * cdr
            bad = np.abs(denom) < 1e-15
            denom = np.where(bad, 1.0, denom)
            xi = cd_ * sdr / denom
            eta = (sd * c0 - cd_ * s0 * cdr) / denom
            xi = np.where(bad, np.nan, xi)
            eta = np.where(bad, np.nan, eta)
        elif p == "SIN":
            xi = cd_ * sdr
            eta = sd * c0 - cd_ * s0 * cdr
        elif p == "ARC":
            cos_c = np.clip(sd * s0 + cd_ * c0 * cdr, -1.0, 1.0)
            c = np.arccos(cos_c)
            k = np.where(np.abs(c) < 1e-15, 1.0, c / np.maximum(np.sin(c),
                                                                1e-30))
            xi = k * cd_ * sdr
            eta = k * (sd * c0 - cd_ * s0 * cdr)
            xi = np.where(np.abs(c) < 1e-15, 0.0, xi)
            eta = np.where(np.abs(c) < 1e-15, 0.0, eta)
        else:  # CAR
            xi = dra * c0
            eta = dec_r - math.radians(self.crval2)
        xi_deg = np.degrees(xi)
        eta_deg = np.degrees(eta)
        det = self.cd[0, 0] * self.cd[1, 1] - self.cd[0, 1] * self.cd[1, 0]
        if abs(det) < 1e-30:
            nan = np.full_like(xi_deg, np.nan)
            return nan, nan
        inv = 1.0 / det
        dx = inv * (self.cd[1, 1] * xi_deg - self.cd[0, 1] * eta_deg)
        dy = inv * (-self.cd[1, 0] * xi_deg + self.cd[0, 0] * eta_deg)
        return dx + self.crpix1 - 1.0, dy + self.crpix2 - 1.0

    def world_to_pixel(self, ra: float, dec: float) -> Tuple[float, float]:
        xs, ys = self.world_to_pixel_batch(np.array([ra]), np.array([dec]))
        return float(xs[0]), float(ys[0])

    # -- scales -----------------------------------------------------------------

    def pixel_scale_arcsec(self) -> float:
        scale_x = math.hypot(self.cd[0, 0], self.cd[1, 0])
        scale_y = math.hypot(self.cd[0, 1], self.cd[1, 1])
        return (scale_x + scale_y) / 2.0 * 3600.0

    def field_of_view(self, naxis1: int, naxis2: int) -> Tuple[float, float]:
        scale_x = math.hypot(self.cd[0, 0], self.cd[1, 0])
        scale_y = math.hypot(self.cd[0, 1], self.cd[1, 1])
        return naxis1 * scale_x * 60.0, naxis2 * scale_y * 60.0
