"""The benchmark's spectral cubes: a JWST NIRSpec IFU s3d-like cube made
on the device from ``--seed``, and written as a FITS file.

A configuration's ``data`` gives the cube's shape and its content, in
MJy/sr, over a linear wavelength axis (``crval3_um`` + z ``cdelt3_um``):

- a uniform background continuum, a power law in wavelength;
- ``sources`` point sources at uniform positions inside the footprint,
  each a power law in wavelength, with a Gaussian PSF whose width grows
  in proportion to the wavelength (``psf_sigma_px`` at ``lambda_ref_um``);
- an inclined exponential disc about the centre with its own
  continuum slope, and six Gaussian emission lines (``lines_um``,
  ``line_sigma_planes`` wide) whose centres follow the disc's rotation,
  ``v_max_kms`` at the flat part of a tanh rotation curve;
- Gaussian noise of ``noise`` on every voxel;
- NaN outside the footprint, a ``footprint_side`` square rotated by
  ``footprint_angle_deg`` about the centre, as an s3d cube's edges are,
  and on ``gap_planes`` whole planes from ``gap_start`` (a detector gap).

Everything comes from ``--seed``: the source table from one
``torch.Generator``, the noise of each block of ``BLOCK`` planes from its
own, seeded from the seed and the block's index. Each voxel is a fixed
sequence of elementwise operations, with no atomics and no reductions,
so a seed gives the same bits on every run on one device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

BLOCK = 64              # planes rendered (and written) at a time
MASK63 = (1 << 63) - 1
C_KMS = 299_792.458


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & MASK63)


def block_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + 104_729 * (k + 1)) & MASK63


def _centre(data):
    return (data["height"] - 1) / 2.0, (data["width"] - 1) / 2.0


def footprint(data: dict, device) -> torch.Tensor:
    """[H, W] bool: inside the rotated square."""
    cy, cx = _centre(data)
    y = torch.arange(data["height"], device=device,
                     dtype=torch.float64)[:, None] - cy
    x = torch.arange(data["width"], device=device,
                     dtype=torch.float64)[None, :] - cx
    a = math.radians(data["footprint_angle_deg"])
    u = math.cos(a) * x + math.sin(a) * y
    v = -math.sin(a) * x + math.cos(a) * y
    half = data["footprint_side"] / 2.0
    return (u.abs() <= half) & (v.abs() <= half)


def sources(data: dict, seed: int, device):
    """(ys, xs, fluxes, slopes) [S] f64 of the point sources, each
    inside the footprint."""
    g = _generator(device, seed)
    inside = footprint(data, device).reshape(-1)
    pick = torch.randint(0, 2 ** 62, (data["sources"],), generator=g,
                         device=device) % int(inside.sum())
    where = torch.nonzero(inside)[:, 0][pick]
    u = torch.rand((data["sources"], 4), generator=g, device=device,
                   dtype=torch.float64)
    ys = (where // data["width"]).double() + u[:, 0] - 0.5
    xs = (where % data["width"]).double() + u[:, 1] - 0.5
    lo, hi = data["source_flux_min"], data["source_flux_max"]
    fluxes = lo * (hi / lo) ** u[:, 2]
    slopes = data["source_slope_min"] + u[:, 3] * (
        data["source_slope_max"] - data["source_slope_min"])
    return ys, xs, fluxes, slopes


def disc_maps(data: dict, device):
    """(surface brightness at lambda_ref, line-of-sight velocity in km/s)
    [H, W] f64 of the inclined rotating disc."""
    cy, cx = _centre(data)
    y = torch.arange(data["height"], device=device,
                     dtype=torch.float64)[:, None] - cy
    x = torch.arange(data["width"], device=device,
                     dtype=torch.float64)[None, :] - cx
    a = math.radians(data["disc_pa_deg"])
    major = math.cos(a) * x + math.sin(a) * y
    minor = (-math.sin(a) * x + math.cos(a) * y) / data["disc_axis_ratio"]
    r = torch.sqrt(major ** 2 + minor ** 2)
    bright = data["disc_peak"] * torch.exp(-r / data["disc_scale_px"])
    cos_phi = torch.where(r > 0, major / torch.clamp(r, min=1e-12), 0.0)
    vel = data["v_max_kms"] * torch.tanh(r / data["v_turn_px"]) * cos_phi
    return bright, vel


def wavelengths_um(data: dict, z0: int, z1: int, device) -> torch.Tensor:
    z = torch.arange(z0, z1, device=device, dtype=torch.float64)
    return data["crval3_um"] + (z + 1.0 - data["crpix3"]) \
        * data["cdelt3_um"]


def render_block(data: dict, seed: int, z0: int, z1: int, device,
                 shared) -> torch.Tensor:
    """Planes [z1 - z0, H, W] f32 of the cube (``z0`` a multiple of
    BLOCK), from what ``scene`` gives."""
    h, w = data["height"], data["width"]
    (ys, xs, fluxes, slopes), (bright, vel), inside = shared
    lam = wavelengths_um(data, z0, z1, device)                  # [k]
    rel = lam / data["lambda_ref_um"]
    cube = (data["background"] * rel ** data["background_slope"]
            )[:, None, None] + bright[None] * (
        rel ** data["disc_slope"])[:, None, None]
    # the point sources: separable Gaussians, width growing with lambda
    sig = data["psf_sigma_px"] * rel                            # [k]
    yy = torch.arange(h, device=device, dtype=torch.float64)
    xx = torch.arange(w, device=device, dtype=torch.float64)
    for i in range(ys.numel()):
        amp = fluxes[i] * rel ** slopes[i] / (2.0 * math.pi * sig ** 2)
        two_var = 2.0 * sig[:, None] ** 2
        gy = torch.exp(-(yy[None, :] - ys[i]) ** 2 / two_var)
        gx = torch.exp(-(xx[None, :] - xs[i]) ** 2 / two_var)
        cube = cube + (amp[:, None] * gy)[:, :, None] * gx[:, None, :]
    # the emission lines, Doppler-shifted by the disc's rotation
    width = data["line_sigma_planes"] * data["cdelt3_um"]
    for lam0, ratio in zip(data["lines_um"], data["line_ratios"]):
        centre = lam0 * (1.0 + vel / C_KMS)                     # [H, W]
        cube = cube + ratio * bright[None] * torch.exp(
            -(lam[:, None, None] - centre[None]) ** 2 / (2.0 * width ** 2))
    out = cube.float()
    noise = torch.empty_like(out).normal_(
        0.0, data["noise"],
        generator=_generator(device, block_seed(seed, z0 // BLOCK)))
    out += noise
    out.masked_fill_(~inside[None], float("nan"))
    g0, g1 = data["gap_start"], data["gap_start"] + data["gap_planes"]
    lo, hi = max(z0, g0), min(z1, g1)
    if lo < hi:
        out[lo - z0:hi - z0] = float("nan")
    return out


def scene(data: dict, seed: int, device):
    """What every block of a cube shares: its sources, disc and
    footprint."""
    return sources(data, seed, device), disc_maps(data, device), \
        footprint(data, device)


def render(data: dict, seed: int, device) -> torch.Tensor:
    """The whole cube [D, H, W] f32 (for small sizes and tests)."""
    sc = scene(data, seed, device)
    return torch.cat([render_block(data, seed, z0, min(z0 + BLOCK,
                                                       data["depth"]),
                                   device, sc)
                      for z0 in range(0, data["depth"], BLOCK)])


def fits_cards(config: dict):
    """(primary cards, SCI cards) of the configuration's file: its
    ``primary_cards``, and its ``sci_cards`` with the spectral axis of
    its ``data``."""
    data = config["data"]
    sci = [tuple(c) for c in config.get("sci_cards", [])]
    sci += [("CTYPE3", "'WAVE'"), ("CUNIT3", "'um'"),
            ("CRVAL3", repr(float(data["crval3_um"]))),
            ("CDELT3", repr(float(data["cdelt3_um"]))),
            ("CRPIX3", repr(float(data["crpix3"])))]
    return [tuple(c) for c in config.get("primary_cards", [])], sci


def write_cube_file(config: dict, seed: int, directory: str,
                    device) -> str:
    """Render the configuration's cube from ``seed`` a block of planes at
    a time and write it, big-endian, as the SCI extension of a FITS file
    behind an empty primary HDU; returns the path."""
    from benchmark.reference.fits_cube import CubeWriter
    data = config["data"]
    shape = (data["depth"], data["height"], data["width"])
    primary, sci = fits_cards(config)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "ifu_s3d.fits")
    sc = scene(data, seed, device)
    with CubeWriter(path, shape, sci, primary) as w:
        for z0 in range(0, data["depth"], BLOCK):
            block = render_block(data, seed, z0,
                                 min(z0 + BLOCK, data["depth"]), device, sc)
            w.write(block.cpu().numpy().astype(np.dtype(">f4")))
    return path
