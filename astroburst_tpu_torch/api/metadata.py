"""Metadata commands (counterpart of astroburst_tpu/api/metadata.py;
reference: src-tauri/src/cmd/metadata/mod.rs).

Each command takes a keyword-only ``device`` (default
``cuda_device()``, which raises where there is no card). Headers come
from the image cache or from a file loaded into it on that device, as
the JAX commands load it; ``get_fits_extensions`` and
``get_header_by_hdu`` read only the file.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch import io as aio
from astroburst_tpu_torch.api.common import Timer, load_cached_full
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.metadata import (PaletteType, detect_filter,
                                           detect_from_filename,
                                           suggest_palette,
                                           suggest_palette_with_type)
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda

_WCS_KEYS = {"CRPIX1", "CRPIX2", "CRVAL1", "CRVAL2", "CDELT1", "CDELT2",
             "CD1_1", "CD1_2", "CD2_1", "CD2_2", "CTYPE1", "CTYPE2",
             "LONPOLE", "LATPOLE", "RADESYS", "EQUINOX", "WCSAXES",
             "A_ORDER", "B_ORDER"}
_OBS_KEYS = {"DATE-OBS", "MJD-OBS", "EXPTIME", "EXPOSURE", "OBJECT",
             "OBSERVER", "TELESCOP", "INSTRUME", "FILTER", "FILTER1",
             "FILTER2", "AIRMASS", "RA", "DEC", "EPOCH", "GAIN", "OFFSET",
             "CCD-TEMP", "SET-TEMP"}
_IMAGE_KEYS = {"NAXIS", "NAXIS1", "NAXIS2", "NAXIS3", "BITPIX", "BSCALE",
               "BZERO", "DATAMIN", "DATAMAX", "BLANK"}
_PROC_KEYS = {"SWCREATE", "SOFTWARE", "HISTORY", "COMMENT", "PROGRAM",
              "CREATOR", "ORIGIN", "PIPELINE"}


def _header_for(path: str, device: torch.device) -> HduHeader:
    entry = GLOBAL_IMAGE_CACHE.get(path)
    if entry is not None and entry.header is not None:
        return entry.header
    entry = load_cached_full(path, device)
    if entry.header is not None:
        return entry.header
    resolved = aio.resolve_single_image(path)
    return aio.extract_image(resolved).header


def get_header(path: str, *,
               device: Optional[torch.device] = None) -> dict:
    """cmd/metadata/mod.rs:20 — raw card list."""
    t0 = Timer()
    header = _header_for(path, device_or_cuda(device))
    return {
        C.RES_FILE_NAME: os.path.basename(path),
        C.RES_FILE_PATH: path,
        C.RES_TOTAL_CARDS: len(header.cards),
        C.RES_CARDS: [{C.RES_KEY: k, C.RES_VALUE: v}
                      for k, v in header.cards],
        C.RES_HEADER: dict(header.index),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _categorize(header: HduHeader) -> dict:
    """mod.rs:91-129 category assignment."""
    categories = {name: {} for name in
                  ("observation", "instrument", "image", "wcs",
                   "processing", "other")}
    for key, val in header.cards:
        ku = key.upper()
        if ku in ("SIMPLE", "END", "EXTEND"):
            continue
        if (ku in _WCS_KEYS or ku.startswith("A_") or ku.startswith("B_")
                or ku.startswith("AP_") or ku.startswith("BP_")):
            cat = "wcs"
        elif ku in _OBS_KEYS:
            cat = "observation"
        elif ku in _IMAGE_KEYS:
            cat = "image"
        elif (ku in _PROC_KEYS or ku.startswith("HISTORY")
              or ku.startswith("COMMENT")):
            cat = "processing"
        elif (ku.startswith("TELESCOP") or ku.startswith("INSTRUME")
              or ku.startswith("CAMERA") or ku.startswith("CCD")
              or ku.startswith("SENSOR")):
            cat = "instrument"
        else:
            cat = "other"
        categories[cat][key] = val
    return categories


def get_full_header(path: str, *,
                    device: Optional[torch.device] = None) -> dict:
    """cmd/metadata/mod.rs:52 — categorized browser + filter detection."""
    t0 = Timer()
    header = _header_for(path, device_or_cuda(device))
    det = detect_filter(header)
    palette = suggest_palette([(path, header)])
    return {
        C.RES_FILE_NAME: os.path.basename(path),
        C.RES_FILE_PATH: path,
        C.RES_TOTAL_CARDS: len(header.cards),
        C.RES_CARDS: [{C.RES_KEY: k, C.RES_VALUE: v}
                      for k, v in header.cards],
        C.RES_CATEGORIES: _categorize(header),
        C.RES_FILTER_DETECTION: det.to_dict() if det else None,
        C.RES_FILENAME_HINT: (palette.palette_name if palette.is_complete
                              else None),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def get_fits_extensions(path: str, *,
                        device: Optional[torch.device] = None) -> dict:
    """cmd/metadata/mod.rs:160."""
    t0 = Timer()
    device_or_cuda(device)
    resolved = aio.resolve_single_image(path)
    infos = aio.list_extensions(resolved)
    return {
        C.RES_EXTENSIONS: [i.to_dict() for i in infos],
        "extension_count": len(infos),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def get_header_by_hdu(path: str, hdu_index: int, *,
                      device: Optional[torch.device] = None) -> dict:
    """cmd/metadata/mod.rs:185."""
    t0 = Timer()
    device_or_cuda(device)
    resolved = aio.resolve_single_image(path)
    img = aio.extract_image_by_index(resolved, hdu_index)
    return {
        C.RES_INDEX: hdu_index,
        C.RES_CARDS: [{C.RES_KEY: k, C.RES_VALUE: v}
                      for k, v in img.header.cards],
        C.RES_TOTAL_CARDS: len(img.header.cards),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def detect_narrowband_filters(paths: Sequence[str],
                              palette: Optional[str] = None, *,
                              device: Optional[torch.device] = None) -> dict:
    """cmd/metadata/mod.rs:195 — per-file detection + palette mapping."""
    t0 = Timer()
    device = device_or_cuda(device)
    files = []
    for p in paths:
        try:
            files.append((p, _header_for(p, device)))
        except Exception:
            files.append((p, HduHeader()))
    ptype = PaletteType.from_str_loose(palette) if palette else PaletteType.SHO
    suggestion = suggest_palette_with_type(files, ptype)
    detections = []
    for p, header in files:
        det = detect_filter(header)
        if det is None:
            det = detect_from_filename(os.path.basename(p))
        detections.append({
            C.RES_FILE_PATH: p,
            C.RES_FILE_NAME: os.path.basename(p),
            C.RES_FILTER_DETECTION: det.to_dict() if det else None,
        })
    return {
        C.RES_FILTERS: detections,
        C.RES_PALETTE: suggestion.to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
