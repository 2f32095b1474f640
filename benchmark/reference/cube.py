"""The plain reference of the eager cube command (``process_cube_cmd``):
plain PyTorch and NumPy in float32, TF32 off.

It follows src-tauri/src/core/cube/eager.rs as the port's docstrings
cite it:

- the mean collapse: per pixel, the mean of the finite values over the
  spectral axis, 0 where there is none (eager.rs:24-28);
- the median collapse: per pixel, the finite non-zero values sorted,
  the one at index cnt // 2, 0 where there is none (eager.rs:28-55,
  ``select_nth``);
- the global statistics of the finite non-zero values of the whole
  cube: the median at rank floor(n / 2), the MAD (the median of
  |v - median| at the same rank) times 1.4826 as sigma (at least
  1e-10), and the values at ranks floor(n * 0.01) and
  min(floor(n * 0.999), n - 1) as the clamp (eager.rs:185-205);
- the preview normalize: each value clamped to [low, high], then
  asinh(10 (v - median) / sigma), non-finite values 0 (eager.rs:210-222);
  then the plane's min/max scaled to 0..255 and truncated to u8;
- the sampled frames: every max(depth // 16, 1)-th plane (eager.rs:224);
- the spectrum of the centre pixel (H // 2, W // 2), the spectral
  classification from CTYPE3/CUNIT3/CDELT3/CRVAL3 (eager.rs:71-145) and
  the linear wavelength axis from CRVAL3/CDELT3/CRPIX3
  (eager.rs:147-159), from the cube HDU's own header.

Departures from eager.rs, each made for the card or to follow the port
where eager.rs leaves a choice:

- n, the count of valid values, is rounded to float32 before the ranks
  are taken from it, as the port and the JAX package take it (above
  2**24 values a rank can differ from the integer one by up to n / 2**25);
- the ranks are read from one ``torch.sort`` of the valid values, not a
  ``select_nth``: the same values;
- the mean sums the planes in order in float32, one plane at a time (the
  order of a per-pixel loop over the spectral axis); its last bits depend
  on that order;
- the wavelength axis is linear in the header's units, with none of
  eager.rs's unit conversions (the port returns it so).

``precision`` "bf16" is the control: the cube and every stage's output
rounded to bfloat16 (``benchmark.reference.rounder``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import rounder

ALPHA = 10.0
MAD_TO_SIGMA = 1.4826
MEDIAN_BLOCK = 1 << 14      # pixels whose spectra are sorted at once
SPECTRAL_CTYPES = ("WAVE", "FREQ", "VELO", "AWAV", "VRAD", "VOPT", "ZOPT",
                   "BETA", "ENER")
SPECTRAL_UNITS = ("M", "CM", "MM", "UM", "NM", "ANGSTROM", "A", "HZ", "KHZ",
                  "MHZ", "GHZ", "M/S", "KM/S", "EV", "KEV")


def _valid(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x) & (x != 0.0)


def ranks(n: int):
    """(median, low, high) 0-based ranks of n valid values, with n
    rounded to float32 as eager.rs takes it."""
    nf = np.float32(n)
    med = np.floor(nf / np.float32(2.0))
    low = min(np.floor(nf * np.float32(0.01)), nf - np.float32(1.0))
    high = min(np.floor(nf * np.float32(0.999)), nf - np.float32(1.0))
    return tuple(max(int(k), 0) for k in (med, low, high))


def global_stats(cube: torch.Tensor, q=lambda t: t) -> dict:
    """median, sigma, low, high of the finite non-zero values."""
    flat = cube.reshape(-1)
    vals = flat[_valid(flat)]
    if vals.numel() == 0:
        return {"median": 0.0, "sigma": 1.0, "low": 0.0, "high": 1.0}
    k_med, k_low, k_high = ranks(vals.numel())
    srt = torch.sort(vals).values
    med, low, high = (srt[k] for k in (k_med, k_low, k_high))
    del srt
    dev = torch.sort(torch.abs(vals - med)).values
    mad = dev[k_med]
    del dev, vals
    med, mad, low, high = (float(q(v)) for v in (med, mad, low, high))
    return {"median": med, "sigma": max(mad * MAD_TO_SIGMA, 1e-10),
            "low": low, "high": high}


def collapse_mean(cube: torch.Tensor) -> torch.Tensor:
    total = torch.zeros(cube.shape[1:], dtype=torch.float32,
                        device=cube.device)
    count = torch.zeros_like(total)
    for z in range(cube.shape[0]):
        plane = cube[z]
        ok = torch.isfinite(plane)
        total += torch.where(ok, plane, 0.0)
        count += ok
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)


def collapse_median(cube: torch.Tensor) -> torch.Tensor:
    depth = cube.shape[0]
    flat = cube.reshape(depth, -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=cube.device)
    for p0 in range(0, flat.shape[1], MEDIAN_BLOCK):
        x = flat[:, p0:p0 + MEDIAN_BLOCK]
        ok = _valid(x)
        cnt = ok.sum(dim=0)
        srt = torch.sort(torch.where(ok, x, math.inf), dim=0).values
        idx = torch.clamp(cnt // 2, max=depth - 1)
        med = torch.gather(srt, 0, idx[None, :])[0]
        out[p0:p0 + x.shape[1]] = torch.where(cnt > 0, med, 0.0)
    return out.reshape(cube.shape[1:])


def normalize(plane: torch.Tensor, st: dict) -> torch.Tensor:
    med, sigma, low, high = (torch.tensor(st[k], dtype=torch.float32,
                                          device=plane.device)
                             for k in ("median", "sigma", "low", "high"))
    clamped = torch.minimum(torch.maximum(plane, low), high)
    scaled = (ALPHA / sigma) * (clamped - med)
    return torch.where(torch.isfinite(plane), torch.asinh(scaled), 0.0)


def to_u8(norm: torch.Tensor) -> torch.Tensor:
    lo = norm.min()
    span = torch.clamp(norm.max() - lo, min=1e-10)
    return torch.clamp((norm - lo) * (255.0 / span), 0, 255).to(torch.uint8)


def _text(header: dict, key: str):
    v = header.get(key)
    return v.strip().strip("'").strip().upper() if v else None


def _number(header: dict, key: str):
    v = header.get(key)
    if v is None:
        return None
    try:
        return float(v.strip().replace("D", "E").replace("d", "e"))
    except ValueError:
        return None


def classify(header: dict, naxis3: int) -> dict:
    """The spectral classification's decision chain."""
    ctype3, cunit3 = _text(header, "CTYPE3"), _text(header, "CUNIT3")
    has_cdelt3 = _number(header, "CDELT3") is not None
    has_crval3 = _number(header, "CRVAL3") is not None

    def out(is_spectral, reason):
        return {"is_spectral": is_spectral, "reason": reason,
                "axis_type": ctype3, "axis_unit": cunit3,
                "channel_count": naxis3}

    if ctype3 is not None and any(s in ctype3 for s in SPECTRAL_CTYPES):
        return out(True, f"CTYPE3 indicates spectral axis: {ctype3}")
    if cunit3 is not None and has_cdelt3 and any(
            cunit3 == s or s in cunit3 for s in SPECTRAL_UNITS):
        return out(True, f"CUNIT3 indicates spectral data: {cunit3}")
    if naxis3 <= 4:
        return out(False, f"NAXIS3={naxis3} with no spectral keywords: "
                   f"likely RGB/RGBA composition")
    if has_cdelt3 and has_crval3:
        return out(True, f"NAXIS3={naxis3} with CRVAL3/CDELT3 present: "
                   f"likely spectral cube")
    if naxis3 > 10:
        return out(True, f"NAXIS3={naxis3}: high channel count suggests "
                   f"spectral data")
    return out(False, f"NAXIS3={naxis3} with no spectral metadata: "
               f"ambiguous, treating as non-spectral")


def wavelengths(header: dict):
    crval3, cdelt3 = _number(header, "CRVAL3"), _number(header, "CDELT3")
    naxis3 = header.get("NAXIS3")
    if crval3 is None or cdelt3 is None or naxis3 is None:
        return None
    crpix3 = _number(header, "CRPIX3") or 1.0
    return [crval3 + (i - crpix3 + 1.0) * cdelt3
            for i in range(int(naxis3))]


def process_cube(cube: torch.Tensor, header: dict,
                 precision: str = "f32") -> dict:
    """What ``process_cube_cmd`` returns and renders, worked out again
    from the cube [D, H, W] and its HDU's header: the header numbers,
    the centre spectrum, the statistics, the collapses, and the u8
    previews of the mean, the median and each sampled frame."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = rounder(precision)
    cube = q(cube)
    depth, rows, cols = cube.shape
    st = global_stats(cube, q)
    mean = q(collapse_mean(cube))
    median = q(collapse_median(cube))
    step = max(depth // 16, 1)
    frames = [to_u8(q(normalize(cube[z], st))).cpu()
              for z in range(0, depth, step)]
    return {"dimensions": [cols, rows, depth],
            "frame_count": len(frames),
            "center_spectrum": cube[:, rows // 2, cols // 2].cpu(),
            "wavelengths": wavelengths(header),
            "classification": classify(header, depth),
            "stats": st, "mean": mean, "median": median,
            "mean_u8": to_u8(q(normalize(mean, st))).cpu(),
            "median_u8": to_u8(q(normalize(median, st))).cpu(),
            "frames_u8": frames}
