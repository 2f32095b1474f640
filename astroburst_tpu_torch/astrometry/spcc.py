"""SPCC, spectrophotometric color calibration (counterpart of
astroburst_tpu/astrometry/spcc.py).

Reference: src-tauri/src/core/astrometry/spcc.rs — detect stars on
synthesized luminance, SNR/saturation/border filters, WCS → sky, Gaia
DR3 TAP (network) with synthetic Bp-Rp catalog fallback, cross-match,
flux-weighted color-ratio regression → R/G/B factors normalized to G,
Planck-curve white references.

The planes stay on their device: the luminance (three f32 products
summed in order, non-finite values kept: ROADMAP C26), the port's
``detect_stars`` on it (kernels K10 and K11) and its largest value.
The quality filter, the sort by SNR, WCS → sky, the catalog and the
cross-match run on the host, as in the JAX package. For the aperture photometry the card gathers one
square window of each plane around every kept star, all in one fetch;
the host cuts each star's exact aperture box out of its window and runs
the JAX package's f64 numpy arithmetic on it, so given the same stars
and planes the fluxes are bit-equal to the JAX package's. The scalar
parts (Planck curves, white references, the Bp-Rp estimate, the Gaia
client and the regression) are copies of the JAX module's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.analysis.star_detection import (DetectedStar,
                                                          detect_stars)
from astroburst_tpu_torch.astrometry.wcs import WcsTransform
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.device import as_f32_all


@dataclass
class SpccConfig:
    min_snr: float = 20.0
    max_stars: int = 200
    saturation_limit: float = 0.90
    catalog: str = "builtin"       # "builtin" | "gaia_dr3"
    white_reference: str = "average_spiral"  # | "g2v" | "photopic" | "custom"
    custom_white: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclass
class SpccResult:
    r_factor: float
    g_factor: float
    b_factor: float
    stars_matched: int
    stars_total: int
    avg_color_index: float
    white_ref_name: str
    catalog_name: str
    is_synthetic_catalog: bool

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def bp_rp_to_teff(bp_rp: float) -> float:
    """Piecewise Bp-Rp → effective temperature (spcc.rs:193-208)."""
    x = min(max(bp_rp, -0.5), 5.0)
    if x < 0.0:
        return 10000.0 + (-x) * 20000.0
    if x < 0.5:
        return 7500.0 + (0.5 - x) * 5000.0
    if x < 1.0:
        return 5800.0 + (1.0 - x) * 3400.0
    if x < 1.5:
        return 4500.0 + (1.5 - x) * 2600.0
    if x < 2.5:
        return 3500.0 + (2.5 - x) * 1000.0
    return 2800.0 + (5.0 - x) * 280.0


def planck_intensity(teff: float, wavelength_nm: float) -> float:
    lam = wavelength_nm * 1e-9
    h, c, k = 6.626e-34, 2.998e8, 1.381e-23
    exponent = h * c / (lam * k * teff)
    if exponent > 500.0:
        return 0.0
    return (2.0 * h * c * c / lam ** 5) / (math.exp(exponent) - 1.0)


def planck_rgb(teff: float) -> Tuple[float, float, float]:
    r = planck_intensity(teff, 640.0)
    g = planck_intensity(teff, 530.0)
    b = planck_intensity(teff, 460.0)
    m = max(r, g, b)
    if m < 1e-30:
        return 1.0, 1.0, 1.0
    return r / m, g / m, b / m


def white_reference_rgb(config: SpccConfig) -> Tuple[float, float, float]:
    wr = config.white_reference
    if wr == "g2v":
        return planck_rgb(5778.0)
    if wr == "photopic":
        return 1.0, 1.0, 1.0
    if wr == "custom":
        return config.custom_white
    r, g, b = planck_rgb(5500.0)  # average spiral
    return r * 0.98, g * 1.0, b * 1.02


def white_reference_name(config: SpccConfig) -> str:
    return {"g2v": "G2V (Solar)", "photopic": "Photopic (Human Eye)",
            "custom": "Custom ({:.2f},{:.2f},{:.2f})".format(
                *config.custom_white)}.get(
        config.white_reference, "Average Spiral Galaxy")


def estimate_bp_rp_from_flux(star: DetectedStar) -> float:
    """Synthetic color index from flux concentration (spcc.rs:264-269)."""
    norm_flux = min(max(star.flux / max(star.peak, 1e-10), 0.1), 100.0)
    fwhm_factor = min(max(star.fwhm - 3.0, -2.0), 5.0) * 0.1
    return min(max(1.0 / math.sqrt(norm_flux) + fwhm_factor, -0.3), 4.0)


GAIA_TAP_URL = "https://gea.esac.esa.int/tap-server/tap/sync"
GAIA_MAX_ROWS = 500
GAIA_MAG_LIMIT = 17.0


def gaia_tap_enabled() -> bool:
    """Opt-in gate for the live Gaia TAP query, mirroring the
    reference's build-time `vizier` feature flag (spcc.rs:273-274
    stubs the client in the default build). Default off: spcc
    calibration must not gain silent external egress (nor a 30 s
    network stall) just because catalog='gaia_dr3' was requested."""
    import os
    return os.environ.get("ASTROBURST_GAIA_TAP", "0") == "1"


def build_gaia_adql(ra: float, dec: float, radius_deg: float,
                    max_rows: int = GAIA_MAX_ROWS,
                    mag_limit: float = GAIA_MAG_LIMIT) -> str:
    """ADQL cone search on gaiadr3.gaia_source (the query the
    reference's `vizier` feature build issues; spcc.rs:273 stubs it in
    the default build)."""
    return (
        f"SELECT TOP {int(max_rows)} ra, dec, bp_rp, phot_g_mean_mag "
        "FROM gaiadr3.gaia_source "
        "WHERE CONTAINS(POINT('ICRS', ra, dec), "
        f"CIRCLE('ICRS', {ra:.8f}, {dec:.8f}, {radius_deg:.6f})) = 1 "
        f"AND phot_g_mean_mag < {mag_limit:.2f} "
        "AND bp_rp IS NOT NULL "
        "ORDER BY phot_g_mean_mag ASC")


def parse_gaia_tap_csv(text: str):
    """CSV TAP response → catalog rows ({ra, dec, bp_rp} dicts).

    Tolerates column reordering via the header line; rows with empty
    or non-numeric ra/dec/bp_rp are skipped.
    """
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    header = [c.strip().lower() for c in lines[0].split(",")]
    try:
        i_ra = header.index("ra")
        i_dec = header.index("dec")
        i_bprp = header.index("bp_rp")
    except ValueError:
        raise InvalidInput(
            f"Gaia TAP response missing ra/dec/bp_rp columns: {header}")
    out = []
    for ln in lines[1:]:
        cols = ln.split(",")
        if len(cols) <= max(i_ra, i_dec, i_bprp):
            continue
        try:
            out.append({"ra": float(cols[i_ra]),
                        "dec": float(cols[i_dec]),
                        "bp_rp": float(cols[i_bprp])})
        except ValueError:
            continue
    return out


def query_gaia_vizier(ra: float, dec: float, radius_deg: float,
                      timeout_s: float = 30.0):
    """Gaia DR3 TAP synchronous cone search.

    Equivalent of the reference's `vizier`-feature client (the default
    build raises instead, spcc.rs:273-274). Offline — as in this
    environment — the request fails and the caller falls back to the
    synthetic Bp-Rp catalog (spcc.rs:125-130).
    """
    import urllib.error
    import urllib.parse
    import urllib.request

    data = urllib.parse.urlencode({
        "REQUEST": "doQuery",
        "LANG": "ADQL",
        "FORMAT": "csv",
        "QUERY": build_gaia_adql(ra, dec, radius_deg),
    }).encode("ascii")
    req = urllib.request.Request(
        GAIA_TAP_URL, data=data,
        headers={"Content-Type": "application/x-www-form-urlencoded",
                 "User-Agent": "astroburst-tpu/0.1"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            text = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise InvalidInput(
            f"Gaia DR3 TAP unavailable ({e}); using built-in Bp-Rp "
            "estimation")
    catalog = parse_gaia_tap_csv(text)
    if not catalog:
        raise InvalidInput("Gaia DR3 TAP returned no usable rows; using "
                           "built-in Bp-Rp estimation")
    return catalog


def luminance(r: torch.Tensor, g: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """BT.709 luminance in f32, each product rounded and summed in
    order, non-finite values kept (spcc.rs:90; ROADMAP C26)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def select_stars(lum: torch.Tensor,
                 config: SpccConfig) -> List[DetectedStar]:
    """Detection at 5 sigma on the luminance (K10, K11), then on the
    host the SNR, saturation and 10 px border filters and the sort by
    SNR, cut to ``config.max_stars`` (spcc.rs:90-110)."""
    h, w = lum.shape
    detection = detect_stars(lum, 5.0)
    sat_limit = compute_image_stats(lum).max * config.saturation_limit
    good = [s for s in detection.stars
            if (s.snr >= config.min_snr and s.peak < sat_limit and
                10.0 <= s.x < w - 10 and 10.0 <= s.y < h - 10)]
    good.sort(key=lambda s: -s.snr)
    return good[:config.max_stars]


def aperture_radius(star: DetectedStar) -> float:
    return max(star.fwhm * 1.5, 3.0)


def gather_windows(planes: Sequence[torch.Tensor],
                   stars: Sequence[DetectedStar]) -> Tuple[np.ndarray, int]:
    """Each plane's square window around (floor(y), floor(x)) of every
    star, gathered on the planes' device (one gather a plane) and
    fetched in one copy: ([S, P, 2·half + 1, 2·half + 1] f32, half).

    half = ceil(outer) + 1 for the largest outer = 1.8 · radius of the
    stars. A star's aperture box spans rows floor(y − outer) ..
    ceil(y + outer), inside floor(y) ± half, and never leaves the
    plane, so the indices clamped to the plane lie outside every box
    that is cut from the window."""
    h, w = planes[0].shape
    half = math.ceil(max(aperture_radius(s) for s in stars) * 1.8) + 1
    offs = np.arange(-half, half + 1)
    rows = np.clip(np.array([math.floor(s.y) for s in stars])[:, None]
                   + offs, 0, h - 1)
    cols = np.clip(np.array([math.floor(s.x) for s in stars])[:, None]
                   + offs, 0, w - 1)
    dev = planes[0].device
    ri = torch.from_numpy(rows).to(dev)[:, :, None]
    ci = torch.from_numpy(cols).to(dev)[:, None, :]
    windows = torch.stack([p[ri, ci] for p in planes], 1)
    return windows.cpu().numpy(), half


def window_flux(window: np.ndarray, star: DetectedStar, half: int,
                h: int, w: int) -> float:
    """Background-annulus-corrected aperture photometry
    (spcc.rs:328-367) on one plane's window of ``star``: the aperture
    box is cut out of the window, then the JAX package's
    ``aperture_flux`` arithmetic runs on it in f64, in the same order."""
    x, y = star.x, star.y
    radius = aperture_radius(star)
    outer = radius * 1.8
    inner = radius * 1.2
    y_min = max(int(math.floor(y - outer)), 0)
    y_max = min(int(math.ceil(y + outer)), h - 1)
    x_min = max(int(math.floor(x - outer)), 0)
    x_max = min(int(math.ceil(x + outer)), w - 1)
    y0 = math.floor(y) - half
    x0 = math.floor(x) - half
    yy, xx = np.mgrid[y_min:y_max + 1, x_min:x_max + 1]
    d2 = (xx - x) ** 2 + (yy - y) ** 2
    patch = window[y_min - y0:y_max - y0 + 1,
                   x_min - x0:x_max - x0 + 1].astype(np.float64)
    flux = float(patch[d2 <= radius * radius].sum())
    annulus = patch[(d2 >= inner * inner) & (d2 <= outer * outer)]
    if annulus.size > 0:
        flux -= float(annulus.mean()) * math.pi * radius * radius
    return max(flux, 0.0)


def compute_correction_factors(matched: Sequence[dict], wr_r: float,
                               wr_g: float, wr_b: float):
    """Flux-weighted color-ratio regression (spcc.rs:369-435)."""
    sum_r = sum_g = sum_b = sum_w = sum_ci = 0.0
    for star in matched:
        teff = bp_rp_to_teff(star["bp_rp"])
        er, eg, eb = planck_rgb(teff)
        tm = star["r"] + star["g"] + star["b"]
        te = er + eg + eb
        if tm < 1e-10 or te < 1e-10:
            continue
        weight = math.sqrt(tm)
        mr, mg, mb = star["r"] / tm, star["g"] / tm, star["b"] / tm
        er, eg, eb = er / te, eg / te, eb / te
        if mr > 1e-6:
            sum_r += (er / mr) * weight
        if mg > 1e-6:
            sum_g += (eg / mg) * weight
        if mb > 1e-6:
            sum_b += (eb / mb) * weight
        sum_w += weight
        sum_ci += star["bp_rp"]
    if sum_w < 1e-10 or not matched:
        return 1.0, 1.0, 1.0, 0.0
    rf = sum_r / sum_w * wr_r
    gf = sum_g / sum_w * wr_g
    bf = sum_b / sum_w * wr_b
    if gf > 1e-10:
        rf /= gf
        bf /= gf
        gf = 1.0
    return rf, gf, bf, sum_ci / len(matched)


def spcc_calibrate_rgb(r_image, g_image, b_image, header: HduHeader,
                       config: SpccConfig = SpccConfig(), *,
                       device=None) -> SpccResult:
    """Full SPCC chain (spcc.rs:73-178). The planes go to ``device``
    (default: the first tensor's device, else ``cuda_device()``)."""
    try:
        wcs = WcsTransform.from_header(header)
    except InvalidInput as e:
        raise InvalidInput(f"WCS not available: {e}. Run Plate Solve first.")

    r, g, b = as_f32_all(r_image, g_image, b_image, device=device)
    h, w = r.shape
    good = select_stars(luminance(r, g, b), config)
    if len(good) < 5:
        raise InvalidInput(
            f"Only {len(good)} stars passed quality filters (need 5+). "
            f"Try lowering min_snr.")

    ras, decs = wcs.pixel_to_world_batch([s.x for s in good],
                                         [s.y for s in good])
    is_synthetic = True
    catalog = None
    if config.catalog == "gaia_dr3" and gaia_tap_enabled():
        try:
            center = wcs.pixel_to_world(w / 2, h / 2)
            catalog = query_gaia_vizier(center.ra, center.dec, 1.0)
            is_synthetic = False
        except InvalidInput:
            catalog = None
    if catalog is None:
        catalog = [{"ra": float(ra), "dec": float(dec),
                    "bp_rp": estimate_bp_rp_from_flux(s)}
                   for ra, dec, s in zip(ras, decs, good)]

    pixel_scale = wcs.pixel_scale_arcsec()
    match_radius = (pixel_scale * 3.0) / 3600.0
    cat_ra = np.array([c["ra"] for c in catalog])
    cat_dec = np.array([c["dec"] for c in catalog])
    windows, half = gather_windows((r, g, b), good)
    matched = []
    for i, star in enumerate(good):
        dra = (ras[i] - cat_ra + 180.0) % 360.0 - 180.0
        dra = dra * math.cos(math.radians(decs[i]))
        ddec = decs[i] - cat_dec
        d2 = dra * dra + ddec * ddec
        j = int(np.argmin(d2))
        if d2[j] < match_radius * match_radius:
            rf, gf, bf = (window_flux(windows[i, c], star, half, h, w)
                          for c in range(3))
            if rf > 0 and gf > 0 and bf > 0:
                matched.append({"bp_rp": catalog[j]["bp_rp"], "r": rf,
                                "g": gf, "b": bf})
    if len(matched) < 3:
        raise InvalidInput(
            f"Only {len(matched)} stars cross-matched (need 3+). Check WCS "
            f"solution quality.")

    wr = white_reference_rgb(config)
    rf, gf, bf, avg_ci = compute_correction_factors(matched, *wr)
    return SpccResult(
        r_factor=rf, g_factor=gf, b_factor=bf, stars_matched=len(matched),
        stars_total=len(good), avg_color_index=avg_ci,
        white_ref_name=white_reference_name(config),
        catalog_name=("Gaia DR3 (VizieR)" if config.catalog == "gaia_dr3"
                      and not is_synthetic else "Built-in Bp-Rp"),
        is_synthetic_catalog=is_synthetic)
