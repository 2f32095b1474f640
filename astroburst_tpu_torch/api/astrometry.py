"""Astrometry commands (counterpart of astroburst_tpu/api/astrometry.py;
reference: src-tauri/src/cmd/astrometry.rs).

Each command takes a keyword-only ``device`` (default ``cuda_device()``,
which raises where there is no card) and resolves it first. The file is
decoded onto that device through the image cache. ``plate_solve_cmd``
resamples a plane past ``MAX_UPLOAD_DIM`` there (Catmull-Rom,
``imaging/resample.resample_image``), fetches it once into a temporary
FITS for the upload and removes the file after; a smaller plane's file
is uploaded as it is. ``get_wcs_info`` reads only the shape and the
header.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api.common import Timer, load_cached_full
from astroburst_tpu_torch.astrometry.plate_solve import (SolveConfig,
                                                         solve_astrometry_net)
from astroburst_tpu_torch.astrometry.wcs import WcsTransform
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.resample import resample_image
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.runtime.config import get_api_key, load_config
from astroburst_tpu_torch.runtime.device import device_or_cuda

MAX_UPLOAD_DIM = 2048  # cmd/astrometry.rs auto-downsample before upload


def plate_solve_cmd(path: str, ra_hint: Optional[float] = None,
                    dec_hint: Optional[float] = None,
                    radius_hint: Optional[float] = None,
                    scale_low: Optional[float] = None,
                    scale_high: Optional[float] = None, *,
                    device: Optional[torch.device] = None) -> dict:
    """cmd/astrometry.rs:38 — astrometry.net solve with auto-downsample."""
    t0 = Timer()
    device = device_or_cuda(device)
    cfg_store = load_config()
    api_key = get_api_key(C.DEFAULT_API_KEY_SERVICE) or \
        cfg_store.astrometry_api_key
    config = SolveConfig(
        api_url=cfg_store.astrometry_api_url, api_key=api_key or "",
        ra_hint=ra_hint, dec_hint=dec_hint,
        radius_hint=radius_hint if radius_hint is not None else 10.0,
        scale_low=scale_low, scale_high=scale_high,
        max_stars=cfg_store.plate_solve_max_stars,
        timeout_secs=cfg_store.plate_solve_timeout_secs)

    img = load_cached_full(path, device).image
    if max(img.shape) <= MAX_UPLOAD_DIM:
        result = solve_astrometry_net(path, config)
    else:
        scale = MAX_UPLOAD_DIM / max(img.shape)
        small = resample_image(img, max(int(img.shape[0] * scale), 1),
                               max(int(img.shape[1] * scale), 1))
        fd, tmp = tempfile.mkstemp(suffix=".fits")
        os.close(fd)
        try:
            write_fits_mono(tmp, small.cpu().numpy())
            result = solve_astrometry_net(tmp, config)
        finally:
            os.unlink(tmp)
    out = result.to_dict()
    out[C.RES_ELAPSED_MS] = t0.elapsed_ms()
    return out


def get_wcs_info(path: str, *,
                 device: Optional[torch.device] = None) -> dict:
    """cmd/astrometry.rs:139 — WCS readout from the header."""
    t0 = Timer()
    entry = load_cached_full(path, device_or_cuda(device))
    if entry.header is None:
        raise InvalidInput("No header available")
    wcs = WcsTransform.from_header(entry.header)
    h, w = entry.image.shape
    center = wcs.pixel_to_world(w / 2.0, h / 2.0)
    fov_w, fov_h = wcs.field_of_view(w, h)
    crpix1, crpix2, crval1, crval2, cd, proj = wcs.raw_params()
    return {
        C.RES_CENTER_RA: center.ra,
        C.RES_CENTER_DEC: center.dec,
        "center_formatted": str(center),
        C.RES_PIXEL_SCALE_ARCSEC: wcs.pixel_scale_arcsec(),
        C.RES_FOV_W_ARCMIN: fov_w,
        C.RES_FOV_H_ARCMIN: fov_h,
        C.RES_WCS_PARAMS: {
            C.RES_WCS_CRPIX1: crpix1,
            C.RES_WCS_CRPIX2: crpix2,
            C.RES_WCS_CRVAL1: crval1,
            C.RES_WCS_CRVAL2: crval2,
            C.RES_WCS_CD: cd,
            C.RES_WCS_PROJECTION: proj,
        },
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
