"""Export commands (counterpart of astroburst_tpu/api/export.py;
reference: src-tauri/src/cmd/export/mod.rs).

``export_fits`` and ``export_fits_rgb`` write FITS at BITPIX −32, 16 or
−64 with the header filtered to WCS and/or metadata cards;
``export_png`` and ``export_rgb_png`` write 8- or 16-bit PNGs through
``io/png``; ``export_zip_bundle`` stores a list of files in a ZIP.
Planes are stretched on the device (``imaging/stf.apply_stf_f32``) and
fetched as f32; the clamp-scale-truncate to u8/u16 and the linear map
of ``export_png`` are the JAX package's host numpy arithmetic, so the
decoded pixels are the same.

Each command takes a keyword-only ``device`` (default
``cuda_device()``), resolved before anything else: ``export_fits``
falls back to reading the file when the cache load fails, and
``export_fits_rgb`` tolerates an unreadable header, and neither
fallback may hide a missing card.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np
import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (Timer, extract_image_resolved,
                                             load_from_cache_or_disk,
                                             try_extract_rgb_resolved)
from astroburst_tpu_torch.dtypes import StfParams
from astroburst_tpu_torch.imaging.resample import resample_image
from astroburst_tpu_torch.imaging.stf import apply_stf_f32
from astroburst_tpu_torch.io import (save_gray_png, save_rgb_png,
                                     write_fits_mono, write_fits_rgb)
from astroburst_tpu_torch.io.fits_writer import filter_header
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda


def _file_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


def export_fits(path: str, output_path: str,
                apply_stf_stretch: Optional[bool] = None,
                shadow: Optional[float] = None,
                midtone: Optional[float] = None,
                highlight: Optional[float] = None,
                copy_wcs: Optional[bool] = None,
                copy_metadata: Optional[bool] = None,
                bitpix: Optional[int] = None, *,
                device: Optional[torch.device] = None) -> dict:
    """User-STF or linear, header filtering, BITPIX (export/mod.rs:16)."""
    t0 = Timer()
    device = device_or_cuda(device)
    do_stf = bool(apply_stf_stretch)
    do_wcs = copy_wcs if copy_wcs is not None else True
    do_meta = copy_metadata if copy_metadata is not None else True
    target_bitpix = bitpix if bitpix is not None else -32

    resolved = extract_image_resolved(path)
    filtered = filter_header(resolved.header, do_wcs, do_meta)
    try:
        source = load_from_cache_or_disk(path, device).image
    except Exception:
        source = _on(resolved.image, device)

    if do_stf:
        stf = StfParams(shadow=shadow or 0.0,
                        midtone=midtone if midtone is not None else 0.5,
                        highlight=highlight if highlight is not None else 1.0)
        source = apply_stf_f32(source, stf, compute_image_stats(source))
    write_fits_mono(output_path, source.cpu().numpy(), filtered,
                    target_bitpix)
    return {
        C.RES_OUTPUT_PATH: output_path,
        C.RES_BITPIX: target_bitpix,
        C.RES_APPLY_STF: do_stf,
        C.COPY_WCS: do_wcs,
        C.RES_COPY_METADATA: do_meta,
        C.RES_FILE_SIZE_BYTES: _file_size(output_path),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def export_fits_rgb(output_path: str, r_path: Optional[str] = None,
                    g_path: Optional[str] = None,
                    b_path: Optional[str] = None,
                    copy_wcs: Optional[bool] = None,
                    copy_metadata: Optional[bool] = None,
                    bitpix: Optional[int] = None, *,
                    device: Optional[torch.device] = None) -> dict:
    """Composite-cache-aware RGB export (export/mod.rs:73): the cached
    composite when all three planes are there, else the three files,
    resampled to the largest rows and columns when their shapes
    differ."""
    t0 = Timer()
    device = device_or_cuda(device)
    do_wcs = copy_wcs if copy_wcs is not None else True
    do_meta = copy_metadata if copy_metadata is not None else True
    target_bitpix = bitpix if bitpix is not None else -32

    cached = [GLOBAL_IMAGE_CACHE.get(k, device) for k in
              (C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B)]
    if all(e is not None for e in cached):
        header = None
        if r_path and not r_path.startswith("__"):
            try:
                header = extract_image_resolved(r_path).header
            except Exception:
                header = None
        if header is None:
            header = cached[0].header
        planes = [e.image for e in cached]
    else:
        if not (r_path and g_path and b_path):
            raise ValueError("R/G/B channel paths required (no composite "
                             "in cache)")
        resolved = [extract_image_resolved(p) for p in (r_path, g_path,
                                                        b_path)]
        planes = [_on(r.image, device) for r in resolved]
        shapes = {tuple(p.shape) for p in planes}
        if len(shapes) > 1:
            rows = max(s[0] for s in shapes)
            cols = max(s[1] for s in shapes)
            planes = [resample_image(p, rows, cols) for p in planes]
        header = resolved[0].header

    filtered = filter_header(header, do_wcs, do_meta) if header else None
    r, g, b = (p.cpu().numpy() for p in planes)
    write_fits_rgb(output_path, r, g, b, filtered, target_bitpix)
    rows, cols = r.shape
    return {
        C.RES_OUTPUT_PATH: output_path,
        C.RES_BITPIX: target_bitpix,
        C.COPY_WCS: do_wcs,
        C.RES_COPY_METADATA: do_meta,
        C.RES_FILE_SIZE_BYTES: _file_size(output_path),
        C.RES_DIMENSIONS: [cols, rows],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _to_u16(plane01: np.ndarray) -> np.ndarray:
    # clamp-then-truncate matches the reference's `as u16` cast
    # (render/rgb.rs:72-74, grayscale.rs)
    return (np.clip(plane01, 0.0, 1.0) * 65535.0).astype(np.uint16)


def _to_u8(plane01: np.ndarray) -> np.ndarray:
    return (np.clip(plane01, 0.0, 1.0) * 255.0).astype(np.uint8)


def export_png(path: str, output_path: str, bit_depth: Optional[int] = None,
               apply_stf_stretch: Optional[bool] = None,
               shadow: Optional[float] = None,
               midtone: Optional[float] = None,
               highlight: Optional[float] = None, *,
               device: Optional[torch.device] = None) -> dict:
    """Mono/RGB PNG with the user's or the linked auto STF
    (export/mod.rs:163). An RGB file is always stretched; a mono one
    without the STF maps its finite range linearly to [0, 1]."""
    t0 = Timer()
    device = device_or_cuda(device)
    depth = bit_depth if bit_depth is not None else 16
    do_stf = bool(apply_stf_stretch)
    user_stf = StfParams(shadow=shadow or 0.0,
                         midtone=midtone if midtone is not None else 0.5,
                         highlight=highlight if highlight is not None else 1.0)
    conv = _to_u16 if depth == 16 else _to_u8

    rgb = try_extract_rgb_resolved(path)
    if rgb is not None:
        planes = [_on(p, device) for p in (rgb.r, rgb.g, rgb.b)]
        stats = [compute_image_stats(p) for p in planes]
        stfs = [user_stf] * 3 if do_stf else \
            [helpers.compute_linked_stf(*stats)] * 3
        arrs = torch.stack([apply_stf_f32(p, prm, st) for p, prm, st
                            in zip(planes, stfs, stats)]).cpu().numpy()
        save_rgb_png(conv(arrs[0]), conv(arrs[1]), conv(arrs[2]),
                     output_path, depth)
        rows, cols = arrs[0].shape
        return {
            C.RES_OUTPUT_PATH: output_path, C.RES_BIT_DEPTH: depth,
            C.RES_APPLY_STF: True,
            C.RES_FILE_SIZE_BYTES: _file_size(output_path),
            C.RES_DIMENSIONS: [cols, rows],
            C.RES_ELAPSED_MS: t0.elapsed_ms(),
        }

    resolved = extract_image_resolved(path)
    if do_stf:
        img = _on(resolved.image, device)
        out01 = apply_stf_f32(img, user_stf,
                              compute_image_stats(img)).cpu().numpy()
    else:
        arr = np.asarray(resolved.image, np.float32)
        finite = arr[np.isfinite(arr)]
        mn = float(finite.min()) if finite.size else 0.0
        mx = float(finite.max()) if finite.size else 1.0
        rng = max(mx - mn, 1e-30)
        out01 = np.where(np.isfinite(arr), np.clip((arr - mn) / rng, 0, 1),
                         0.0)
    save_gray_png(conv(out01), output_path, depth if depth == 16 else 8)
    rows, cols = out01.shape
    return {
        C.RES_OUTPUT_PATH: output_path, C.RES_BIT_DEPTH: depth,
        C.RES_APPLY_STF: do_stf,
        C.RES_FILE_SIZE_BYTES: _file_size(output_path),
        C.RES_DIMENSIONS: [cols, rows],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def export_rgb_png(output_path: str, bit_depth: Optional[int] = None,
                   shadow_r: float = 0.0, midtone_r: float = 0.5,
                   highlight_r: float = 1.0,
                   shadow_g: float = 0.0, midtone_g: float = 0.5,
                   highlight_g: float = 1.0,
                   shadow_b: float = 0.0, midtone_b: float = 0.5,
                   highlight_b: float = 1.0, *,
                   device: Optional[torch.device] = None) -> dict:
    """Composite-cache RGB PNG export with per-channel STF."""
    t0 = Timer()
    device = device_or_cuda(device)
    depth = bit_depth if bit_depth is not None else 16
    entries = helpers.load_composite_rgb(device)
    params = [StfParams(shadow_r, midtone_r, highlight_r),
              StfParams(shadow_g, midtone_g, highlight_g),
              StfParams(shadow_b, midtone_b, highlight_b)]
    arrs = torch.stack([apply_stf_f32(e.image, p, e.stats)
                        for e, p in zip(entries, params)]).cpu().numpy()
    conv = _to_u16 if depth == 16 else _to_u8
    save_rgb_png(conv(arrs[0]), conv(arrs[1]), conv(arrs[2]), output_path,
                 depth)
    rows, cols = arrs[0].shape
    return {
        C.RES_OUTPUT_PATH: output_path, C.RES_BIT_DEPTH: depth,
        C.RES_FILE_SIZE_BYTES: _file_size(output_path),
        C.RES_DIMENSIONS: [cols, rows],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def export_zip_bundle(file_paths, zip_path: str, progress_cb=None, *,
                      device: Optional[torch.device] = None) -> dict:
    """Bundle exported artifacts into an uncompressed ZIP.

    Reference behavior: src/hooks/useZipExport.ts — collects the done
    files' rendered PNGs into a JSZip archive with STORE compression
    (no deflate), renaming *.fits → *.png, skipping unreadable entries,
    and reporting progress 0–90 over files + 90–100 over the write.
    Here any artifact list zips server-side; `progress_cb(pct)` mirrors
    the hook's progress points. A host-only command; ``device`` is
    resolved all the same, as by every command of the port.
    """
    t0 = Timer()
    device_or_cuda(device)
    names_seen = set()
    written = []
    skipped = []
    with zipfile.ZipFile(zip_path, "w",
                         compression=zipfile.ZIP_STORED) as zf:
        n = max(len(file_paths), 1)
        for i, path in enumerate(file_paths):
            base = os.path.basename(path)
            if base.lower().endswith((".fits", ".fit")):
                base = os.path.splitext(base)[0] + ".png"
            name = base
            k = 1
            while name in names_seen:
                stem, ext = os.path.splitext(base)
                name = f"{stem}_{k}{ext}"
                k += 1
            try:
                zf.write(path, arcname=name)
                names_seen.add(name)
                written.append(name)
            except OSError:
                skipped.append(path)
            if progress_cb is not None:
                progress_cb(round((i + 1) / n * 90))
    if progress_cb is not None:
        progress_cb(100)
    return {
        C.RES_PATH: zip_path,
        "files": written,
        "skipped": skipped,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
