"""The benchmark's colour composites: one sky rendered through three
JWST NIRCam filters at two pixel scales, made on the device from
``--seed`` and written as three i2d-like FITS files.

A configuration's ``data`` gives the short-wave (SW) grid, ``sw_height``
x ``sw_width`` pixels of ``sw_scale_arcsec``, the long-wave (LW) grid,
``lw_height`` x ``lw_width`` pixels of ``lw_scale_arcsec``, and
``channels``: for each of r, g and b its filter, grid, pivot wavelength,
PSF FWHM, background, read noise and nebula scale. Positions on the sky
are measured in pixels of the reference frame: the SW grid onto which
the compose resamples R. What the sky holds:

- ``stars`` point sources at uniform positions at least ``margin_px``
  inside the frame, total fluxes log-uniform in [``flux_min``,
  ``flux_max``] at ``lambda_ref_um`` and a colour: a power law in
  wavelength of slope uniform in [``colour_min``, ``colour_max``]
  (negative: a star's Rayleigh-Jeans tail fades toward F444W);
- each star's profile: a Gaussian of the filter's FWHM, widened by the
  pixel (variance + 1/12 pixel squared, as a detector's pixel and the
  mosaic's resampling widen it);
- ``galaxies`` background galaxies at uniform positions: exponential
  discs of total flux log-uniform in [``galaxy_flux_min``,
  ``galaxy_flux_max``], scale length uniform in [``galaxy_re_min``,
  ``galaxy_re_max``] SW pixels (half-light radius), axis ratio uniform
  in [``galaxy_axis_min``, 1] at a uniform angle, and a colour slope
  uniform in [``galaxy_colour_min``, ``galaxy_colour_max``] (redder
  than the stars, as distant galaxies are); point-symmetric, so a
  galaxy's light centre is its position in every filter. Each source
  is summed out to ``window_px`` SW pixels;
- a nebula: a Gaussian of ``nebula_sigma_px`` about (``nebula_y``,
  ``nebula_x``) of the frame, ``nebula_peak`` times the channel's
  ``nebula_scale`` at its centre, brighter in F444W;
- Gaussian read noise on every pixel, and NaN outside the channel's
  footprint: a rectangle of the grid's ``footprint_frac`` (rows,
  columns) rotated by ``footprint_angle_deg`` about the grid's centre,
  the LW one moved by ``lw_footprint_offset_px`` (rows, columns) of LW
  pixels.

R (F444W) is rendered on the LW grid: a sky point (y, x) lies at LW
pixel (y s_y + (s_y - 1) / 2, x s_x + (s_x - 1) / 2), s = LW / SW
pixels, the inverse of the compose's bicubic harmonize, so the
harmonized R holds each star at its sky position. G (F200W) and B
(F090W) are rendered on the SW grid, each misregistered against R by
its own affine T (rotation within ``rotation_max_deg``, scale within
``scale_max`` of 1, shift within ``shift_max_px``, about the frame's
centre): a sky point p lies at T(p) in the channel. T maps reference
pixels to target pixels, as the port's recovered transform does, so the
two compare directly.

Everything comes from ``--seed``: the sources, the colours and the
transforms from one ``torch.Generator``, each channel's noise from its
own. The sources are summed in fixed point (multiples of 2**-32, int64)
by one ``index_add_``, so a seed gives the same bits on every run on
one device.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil

import numpy as np
import torch

FIXED = 2.0 ** 32      # the fixed point of the source sums
MASK63 = (1 << 63) - 1
CHANNELS = ("r", "g", "b")
RE_TO_SCALE = 1.678    # an exponential disc's half-light radius / scale


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & MASK63)


def channel_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + 15_485_863 * (k + 1)) & MASK63


def grid_shape(data: dict, grid: str):
    return data[f"{grid}_height"], data[f"{grid}_width"]


def grid_scale(data: dict):
    """(s_y, s_x): LW pixels per SW pixel along each axis, as the
    harmonize resamples (source size over target size)."""
    return (data["lw_height"] / data["sw_height"],
            data["lw_width"] / data["sw_width"])


def _affine(theta_deg, scale, dy, dx, cy, cx):
    """[a, b, tx, c, d, ty] (f64) of p -> c + shift + s R(theta) (p - c)
    in (x, y) = (column, row)."""
    t = math.radians(theta_deg)
    a, b = scale * math.cos(t), -scale * math.sin(t)
    c, d = scale * math.sin(t), scale * math.cos(t)
    tx = cx + dx - (a * cx + b * cy)
    ty = cy + dy - (c * cx + d * cy)
    return [a, b, tx, c, d, ty]


def scene(data: dict, seed: int, device):
    """(sources: a dict of [S] f64 columns on ``device``, stars first:
    ``y``, ``x``, ``flux``, ``colour``, and for the galaxies ``re`` (0
    for a star), ``axis``, ``angle``; transforms: {channel: [a, b, tx,
    c, d, ty]} of G and B, host floats)."""
    g = _generator(device, seed)
    h, w = data["sw_height"], data["sw_width"]
    m = data["margin_px"]
    ns, ng = data["stars"], data["galaxies"]
    u = torch.rand((ns + ng, 7), generator=g, device=device,
                   dtype=torch.float64)
    star = torch.arange(ns + ng, device=device) < ns

    def log_uniform(t, lo, hi):
        return lo * (hi / lo) ** t

    src = {
        "y": m + u[:, 0] * (h - 1 - 2 * m),
        "x": m + u[:, 1] * (w - 1 - 2 * m),
        "flux": torch.where(
            star, log_uniform(u[:, 2], data["flux_min"], data["flux_max"]),
            log_uniform(u[:, 2], data["galaxy_flux_min"],
                        data["galaxy_flux_max"])),
        "colour": torch.where(
            star, data["colour_min"] + u[:, 3] * (data["colour_max"]
                                                  - data["colour_min"]),
            data["galaxy_colour_min"] + u[:, 3] * (
                data["galaxy_colour_max"] - data["galaxy_colour_min"])),
        "re": torch.where(star, 0.0, data["galaxy_re_min"] + u[:, 4] * (
            data["galaxy_re_max"] - data["galaxy_re_min"])),
        "axis": data["galaxy_axis_min"] + u[:, 5] * (
            1.0 - data["galaxy_axis_min"]),
        "angle": u[:, 6] * math.pi,
    }
    v = torch.rand((2, 4), generator=g, device=device,
                   dtype=torch.float64).cpu().tolist()
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    transforms = {}
    for ch, (ur, us, uy, ux) in zip(("g", "b"), v):
        transforms[ch] = _affine(
            (2 * ur - 1) * data["rotation_max_deg"],
            1.0 + (2 * us - 1) * data["scale_max"],
            (2 * uy - 1) * data["shift_max_px"],
            (2 * ux - 1) * data["shift_max_px"], cy, cx)
    return src, transforms


def _channel(data: dict, name: str) -> dict:
    for c in data["channels"]:
        if c["channel"] == name:
            return c
    raise KeyError(f"no channel {name!r} in the configuration")


def to_grid(data, ch, transforms, ys, xs):
    """Sky positions (SW reference pixels) to the channel's pixels."""
    if ch["grid"] == "lw":
        sy, sx = grid_scale(data)
        return ys * sy + (sy - 1) / 2.0, xs * sx + (sx - 1) / 2.0
    if ch["channel"] not in transforms:
        return ys, xs
    a, b, tx, c, d, ty = transforms[ch["channel"]]
    return c * xs + d * ys + ty, a * xs + b * ys + tx


def to_sky(data, ch, transforms, ys, xs):
    """The channel's pixels to sky positions (the inverse of
    ``to_grid``)."""
    if ch["grid"] == "lw":
        sy, sx = grid_scale(data)
        return (ys - (sy - 1) / 2.0) / sy, (xs - (sx - 1) / 2.0) / sx
    if ch["channel"] not in transforms:
        return ys, xs
    a, b, tx, c, d, ty = transforms[ch["channel"]]
    det = a * d - b * c
    u, v = xs - tx, ys - ty
    return (-c * u + a * v) / det, (d * u - b * v) / det


def footprint(data: dict, ch: dict, device) -> torch.Tensor:
    """[H, W] bool of the channel's grid: inside its rotated rectangle."""
    h, w = grid_shape(data, ch["grid"])
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    if ch["grid"] == "lw":
        cy += data["lw_footprint_offset_px"][0]
        cx += data["lw_footprint_offset_px"][1]
    y = torch.arange(h, device=device, dtype=torch.float64)[:, None] - cy
    x = torch.arange(w, device=device, dtype=torch.float64)[None, :] - cx
    t = math.radians(data["footprint_angle_deg"])
    u = math.cos(t) * x + math.sin(t) * y
    v = -math.sin(t) * x + math.cos(t) * y
    fh, fw = data["footprint_frac"]
    return (v.abs() <= fh * h / 2.0) & (u.abs() <= fw * w / 2.0)


def _profile(data: dict, ch: dict, src: dict, dy, dx) -> torch.Tensor:
    """Each source's surface brightness per unit flux (over SW pixel
    areas) at sky offsets (dy, dx) [S, k, k] in SW pixels: a star's
    Gaussian, a galaxy's exponential disc."""
    pix = data[f"{ch['grid']}_scale_arcsec"] / data["sw_scale_arcsec"]
    fwhm = ch["fwhm_arcsec"] / data["sw_scale_arcsec"]
    var = (fwhm / 2.3548200450309493) ** 2 + pix * pix / 12.0
    star = torch.exp(-(dy * dy + dx * dx) / (2.0 * var)) \
        / (2.0 * math.pi * var)
    re, q, ang = (src[k][:, None, None] for k in ("re", "axis", "angle"))
    scale = torch.clamp(re, min=1e-6) / RE_TO_SCALE
    u = torch.cos(ang) * dx + torch.sin(ang) * dy
    v = (-torch.sin(ang) * dx + torch.cos(ang) * dy) / q
    disc = torch.exp(-torch.sqrt(u * u + v * v) / scale) \
        / (2.0 * math.pi * scale * scale * q)
    return torch.where(re > 0, disc, star)


def render_channel(data: dict, seed: int, name: str, device,
                   shared=None) -> torch.Tensor:
    """The channel's plane [H, W] f32 of its grid (NaN outside its
    footprint)."""
    src, transforms = shared or scene(data, seed, device)
    k = CHANNELS.index(name)
    ch = _channel(data, name)
    h, w = grid_shape(data, ch["grid"])
    pix = data[f"{ch['grid']}_scale_arcsec"] / data["sw_scale_arcsec"]
    # the nebula, on the sky under each pixel, and the background
    py = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    px = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    sy, sx = to_sky(data, ch, transforms, py.expand(h, w), px.expand(h, w))
    ny = data["nebula_y"] * (data["sw_height"] - 1)
    nx = data["nebula_x"] * (data["sw_width"] - 1)
    neb = data["nebula_peak"] * ch["nebula_scale"] * torch.exp(
        -((sy - ny) ** 2 + (sx - nx) ** 2)
        / (2.0 * data["nebula_sigma_px"] ** 2))
    del sy, sx
    plane = (ch["background"] + neb).float()
    del neb
    plane += torch.empty_like(plane).normal_(
        0.0, ch["read_noise"],
        generator=_generator(device, channel_seed(seed, k)))
    # the sources, in fixed point
    gy, gx = to_grid(data, ch, transforms, src["y"], src["x"])
    rad = int(math.ceil(data["window_px"] / pix))
    r = torch.arange(-rad, rad + 1, device=device)
    iy = torch.round(gy).long()[:, None, None] + r[:, None]
    ix = torch.round(gx).long()[:, None, None] + r[None, :]
    wy, wx = to_sky(data, ch, transforms, iy.double(), ix.double())
    dy = wy - src["y"][:, None, None]
    dx = wx - src["x"][:, None, None]
    flux = src["flux"] * (ch["lambda_um"] / data["lambda_ref_um"]) \
        ** src["colour"]
    inside = dy * dy + dx * dx <= data["window_px"] ** 2
    val = torch.round(FIXED * flux[:, None, None] * inside
                      * _profile(data, ch, src, dy, dx)).long()
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    acc = torch.zeros(h * w, dtype=torch.int64, device=device)
    acc.index_add_(0, (iy * w + ix)[ok], val[ok])
    plane.view(-1).add_((acc.double() / FIXED).float())
    plane.masked_fill_(~footprint(data, ch, device), float("nan"))
    return plane


def render(data: dict, seed: int, device):
    """({channel: plane}, {channel: transform of G and B})."""
    shared = scene(data, seed, device)
    return ({c: render_channel(data, seed, c, device, shared)
             for c in CHANNELS}, shared[1])


def fits_cards(config: dict, name: str):
    """(primary cards, SCI cards) of the channel's file."""
    ch = _channel(config["data"], name)
    primary = [tuple(c) for c in config.get("primary_cards", [])]
    primary += [("FILTER", f"'{ch['filter']}'"),
                ("PUPIL", f"'{ch['pupil']}'"),
                ("CHANNEL", "'LONG'" if ch["grid"] == "lw" else "'SHORT'")]
    return primary, [tuple(c) for c in config.get("sci_cards", [])]


def cache_key(config: dict, seed: int) -> str:
    """The name of a composite's directory: a hash of this generator's
    and the writer's sources, the configuration and the seed."""
    here = os.path.dirname(os.path.abspath(__file__))
    ref = os.path.join(os.path.dirname(here), "reference")
    h = hashlib.sha256()
    for path in (os.path.abspath(__file__),
                 os.path.join(ref, "fits_image.py"),
                 os.path.join(ref, "fits_cube.py"),
                 os.path.join(ref, "fits.py")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(json.dumps({k: config.get(k) for k in (
        "data", "primary_cards", "sci_cards")}, sort_keys=True).encode())
    h.update(f"{seed}".encode())
    return h.hexdigest()[:20]


def rgb_files(config: dict, seed: int, cache_root: str, device,
              keep: int = 4):
    """({channel: path} of the three files under
    ``cache_root/rgb/<key>/``, {channel: true transform} of G and B).
    The files are written once by the benchmark's own writer (into a
    ``.partial`` directory named after the process, then renamed, so
    two runs of one seed do not remove each other's) and reused by later
    runs with this seed; the ``keep`` newest composites are kept. The
    transforms are drawn again from the seed, which is cheap."""
    from benchmark.reference.fits_image import write_sci_image
    data = config["data"]
    root = os.path.join(cache_root, "rgb")
    final = os.path.join(root, cache_key(config, seed))
    paths = {c: os.path.join(final, f"{c}_{_channel(data, c)['filter']}"
                             "_i2d.fits") for c in CHANNELS}
    shared = scene(data, seed, device)
    if os.path.isfile(os.path.join(final, "done")):
        os.utime(final)
        return paths, shared[1]
    os.makedirs(root, exist_ok=True)
    part = f"{final}.{os.getpid()}.partial"     # this process's own
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    for c in CHANNELS:
        plane = render_channel(data, seed, c, device, shared)
        primary, sci = fits_cards(config, c)
        write_sci_image(os.path.join(part, os.path.basename(paths[c])),
                        plane.cpu().numpy().astype(np.dtype(">f4")),
                        primary, sci)
        del plane
    open(os.path.join(part, "done"), "w").close()
    if os.path.isfile(os.path.join(final, "done")):
        shutil.rmtree(part, ignore_errors=True)   # another run wrote it
    else:
        shutil.rmtree(final, ignore_errors=True)
        os.replace(part, final)
    sets = sorted((e for e in os.scandir(root)
                   if e.is_dir() and not e.name.endswith(".partial")),
                  key=lambda e: e.stat().st_mtime, reverse=True)
    for old in sets[keep:]:
        shutil.rmtree(old.path, ignore_errors=True)
    return paths, shared[1]
