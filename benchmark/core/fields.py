"""The benchmark's inputs: dithered star fields made on the device.

A configuration's ``data`` gives the frames' shape and what is in
them: ``stars`` Gaussian stars (peak ``amp_min``..``amp_max``, width
``psf_sigma``) at uniform positions, over ``background`` with Gaussian
read noise ``read_noise``, each frame k > 0 dithered by a sub-pixel
(dy, dx) uniform in ±``dither_max`` (frame 0 is the reference, at 0).
Every frame is rendered at its own dither, so the alignment has to
find sub-pixel offsets as a user's dithers give them.

Everything comes from ``--seed``: the star table and the dithers from
one ``torch.Generator`` on the device, each frame's noise from its own
(seeded from the seed and the frame's index, so the first frames of a
set do not depend on how many follow). The stars are summed in fixed
point (multiples of 2**-32, in int64) by one ``index_add_``: integer
sums do not depend on the order of the device's atomic adds, so a seed
gives the same bits on every run. (The sort-based accumulation of
``index_put_`` took ~8 s at its first use on the card.)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import torch

RADIUS = 7            # star windows are (2 RADIUS + 1)^2 pixels
FIXED = 2.0 ** 32     # the fixed point of the star sums
MASK63 = (1 << 63) - 1


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & MASK63)


def frame_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + 7919 * (k + 1)) & MASK63


def scene(data: dict, seed: int, device):
    """(ys, xs, amps [S] f64, dithers [N, 2] f64 (dy, dx)) of a set."""
    g = _generator(device, seed)
    h, w, s = data["height"], data["width"], data["stars"]
    u = torch.rand((s, 3), generator=g, device=device, dtype=torch.float64)
    ys = 8.0 + u[:, 0] * (h - 16)
    xs = 8.0 + u[:, 1] * (w - 16)
    amps = data["amp_min"] + u[:, 2] * (data["amp_max"] - data["amp_min"])
    d = torch.rand((data["frames"], 2), generator=g, device=device,
                   dtype=torch.float64)
    dithers = (2.0 * d - 1.0) * data["dither_max"]
    dithers[0] = 0.0
    return ys, xs, amps, dithers


def render(data: dict, seed: int, device, frames=None) -> torch.Tensor:
    """The frames [n, H, W] f32 of a set (the first ``frames`` of it)."""
    n = data["frames"] if frames is None else frames
    h, w = data["height"], data["width"]
    ys, xs, amps, dithers = scene(data, seed, device)
    out = torch.empty((n, h, w), dtype=torch.float32, device=device)
    for k in range(n):
        out[k].normal_(data["background"], data["read_noise"],
                       generator=_generator(device, frame_seed(seed, k)))
    r = torch.arange(-RADIUS, RADIUS + 1, device=device)
    cy = ys[None, :] + dithers[:n, 0:1]                 # [n, S]
    cx = xs[None, :] + dithers[:n, 1:2]
    iy = torch.round(cy).long()[..., None, None] + r[:, None]
    ix = torch.round(cx).long()[..., None, None] + r[None, :]
    d2 = (iy - cy[..., None, None]) ** 2 + (ix - cx[..., None, None]) ** 2
    val = torch.round(FIXED * amps[None, :, None, None] * torch.exp(
        -d2 / (2.0 * data["psf_sigma"] ** 2))).long()
    frame = torch.arange(n, device=device)[:, None, None, None]
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (frame * h + iy) * w + ix
    acc = torch.zeros(n * h * w, dtype=torch.int64, device=device)
    acc.index_add_(0, flat[ok], val[ok])
    out.view(-1).add_((acc.double() / FIXED).float())
    return out


def cache_key(config: dict, seed: int, frames: int) -> str:
    """The name of a set's directory of FITS files: a hash of this
    generator's and the FITS writer's sources, the configuration's data
    and the seed."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for path in (os.path.join(here, "fields.py"),
                 os.path.join(os.path.dirname(here), "reference", "fits.py")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(json.dumps(config["data"], sort_keys=True).encode())
    h.update(json.dumps(config.get("fits_cards", []), sort_keys=True).encode())
    h.update(f"{seed}:{frames}".encode())
    return h.hexdigest()[:20]


def fits_files(config: dict, seed: int, frames: int, cache_root: str,
               device, keep: int = 8):
    """Paths of the set's FITS files under ``cache_root/<key>/``, written
    once by the benchmark's own writer (into ``<key>.partial``, then
    renamed) and reused by later runs with this seed. Keeps the
    ``keep`` newest sets. Returns (paths, the frames when they were
    made here, else None)."""
    from benchmark.reference.fits import write_fits
    key = cache_key(config, seed, frames)
    final = os.path.join(cache_root, key)
    names = [f"frame_{k:03d}.fits" for k in range(frames)]
    paths = [os.path.join(final, n) for n in names]
    if os.path.isfile(os.path.join(final, "done")):
        os.utime(final)
        return paths, None
    os.makedirs(cache_root, exist_ok=True)
    part = final + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    planes = render(config["data"], seed, device, frames)
    host = planes.cpu().numpy()
    for k, name in enumerate(names):
        cards = [(key_, val) for key_, val in config.get("fits_cards", [])]
        cards.append(("FRAME", str(k)))
        write_fits(os.path.join(part, name), host[k], cards)
    open(os.path.join(part, "done"), "w").close()
    shutil.rmtree(final, ignore_errors=True)
    os.replace(part, final)
    sets = sorted((e for e in os.scandir(cache_root)
                   if e.is_dir() and not e.name.endswith(".partial")),
                  key=lambda e: e.stat().st_mtime, reverse=True)
    for old in sets[keep:]:
        shutil.rmtree(old.path, ignore_errors=True)
    return paths, planes
