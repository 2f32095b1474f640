"""File ingestion commands: process_fits, process_fits_full,
get_raw_pixels_preview (counterpart of astroburst_tpu/api/io.py).

Reference: src-tauri/src/cmd/io/mod.rs:105-196. Response keys match
the reference verbatim; RGB-FITS (NAXIS3 in [3,4]) auto-detection
seeds the composite ORIG/KEY cache (io/mod.rs:33-102). Each command
takes a keyword-only ``device`` (default ``cuda_device()``).
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM,
                                             MAX_RAW_PREVIEW_DIM, Timer,
                                             extract_image_resolved,
                                             load_cached, load_cached_full,
                                             png_path_for,
                                             try_extract_rgb_resolved)
from astroburst_tpu_torch.dtypes import AutoStfConfig
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io.prefetch import DeviceLoader
from astroburst_tpu_torch.ops.ipc import encode_with_header_downsampled
from astroburst_tpu_torch.ops.stats import (compute_histogram_with_stats,
                                            compute_image_stats)
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir


def _histogram_payload(x, stats, stf_params) -> dict:
    with trace.span("stats.histogram"):
        hist = compute_histogram_with_stats(x, stats,
                                            bins=C.HISTOGRAM_BINS_DISPLAY)
    return {
        C.RES_BINS: hist.bins,
        C.RES_BIN_COUNT: len(hist.bins),
        C.RES_DATA_MIN: stats.min,
        C.RES_DATA_MAX: stats.max,
        C.RES_MEDIAN: stats.median,
        C.RES_MEAN: stats.mean,
        C.RES_SIGMA: stats.sigma,
        C.RES_MAD: stats.mad,
        C.RES_TOTAL_PIXELS: stats.valid_count,
        C.RES_AUTO_STF: helpers.stf_json(stf_params),
    }


def _process_rgb_fits(path: str, output_dir: str, t0: Timer, full: bool,
                      device: torch.device) -> Optional[dict]:
    rgb = try_extract_rgb_resolved(path)
    if rgb is None:
        return None
    r, g, b = (torch.from_numpy(p).to(device) for p in (rgb.r, rgb.g, rgb.b))
    stats_r = compute_image_stats(r)
    stats_g = compute_image_stats(g)
    stats_b = compute_image_stats(b)
    cfg = AutoStfConfig()
    stf_r = auto_stf(stats_r, cfg)
    stf_g = auto_stf(stats_g, cfg)
    stf_b = auto_stf(stats_b, cfg)

    png_path = png_path_for(path, output_dir)
    helpers.render_rgb_preview_with_stf(
        r, g, b, stf_r, stf_g, stf_b, stats_r, stats_g, stats_b,
        png_path, MAX_PREVIEW_DIM)

    result = {
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [r.shape[1], r.shape[0]],
        C.RES_STATS: helpers.stats_json_full(stats_r),
        C.RES_STF: helpers.stf_json(stf_r),
        "is_rgb": True,
        C.STF_R: helpers.stf_json(stf_r),
        C.STF_G: helpers.stf_json(stf_g),
        C.STF_B: helpers.stf_json(stf_b),
    }
    if full:
        result[C.RES_HEADER] = dict(rgb.header.index)
        result[C.RES_HISTOGRAM] = _histogram_payload(r, stats_r, stf_r)

    helpers.insert_composite_and_orig(r, g, b, stats_r, stats_g, stats_b)
    result[C.RES_ELAPSED_MS] = t0.elapsed_ms()
    return result


def process_fits(path: str, output_dir: str = "", *,
                 device: Optional[torch.device] = None) -> dict:
    """Decode + stats + auto-STF preview PNG (io/mod.rs:105)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    rgb_result = _process_rgb_fits(path, out_dir, t0, False, device)
    if rgb_result is not None:
        return rgb_result
    entry = load_cached(path, device)
    stf_params = auto_stf(entry.stats)
    png_path = png_path_for(path, out_dir)
    helpers.save_stf_preview_png(entry.image, stf_params, entry.stats,
                                 png_path, MAX_PREVIEW_DIM)
    h, w = entry.image.shape
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
        C.RES_STATS: helpers.stats_json(entry.stats),
        C.RES_STF: helpers.stf_json(stf_params),
    }


def process_fits_full(path: str, output_dir: str = "", *,
                      device: Optional[torch.device] = None) -> dict:
    """process_fits + 512-bin display histogram + header (io/mod.rs:129)."""
    with trace.span("api.process_fits_full"):
        t0 = Timer()
        device = device_or_cuda(device)
        out_dir = resolve_output_dir(output_dir)
        rgb_result = _process_rgb_fits(path, out_dir, t0, True, device)
        if rgb_result is not None:
            return rgb_result
        entry = load_cached_full(path, device)
        stats = entry.stats
        with trace.span("stats.stf"):
            stf_params = auto_stf(stats)
        png_path = png_path_for(path, out_dir)
        helpers.save_stf_preview_png(entry.image, stf_params, stats,
                                     png_path, MAX_PREVIEW_DIM)
        h, w = entry.image.shape
        return {
            C.RES_PNG_PATH: png_path,
            C.RES_DIMENSIONS: [w, h],
            C.RES_ELAPSED_MS: t0.elapsed_ms(),
            C.RES_STATS: helpers.stats_json_full(stats),
            C.RES_STF: helpers.stf_json(stf_params),
            C.RES_HEADER: dict(entry.header.index) if entry.header else None,
            C.RES_HISTOGRAM: _histogram_payload(entry.image, stats,
                                                stf_params),
        }


def get_raw_pixels_preview(path: str, max_dim: Optional[int] = None, *,
                           device: Optional[torch.device] = None
                           ) -> bytearray:
    """Binary response: 16-byte header + raw f32 (io/mod.rs:175)."""
    device = device_or_cuda(device)
    dim = max_dim or MAX_RAW_PREVIEW_DIM
    entry = GLOBAL_IMAGE_CACHE.get(path, device)
    if entry is not None:
        image = entry.image
    else:
        image = DeviceLoader(device, extract_image_resolved)(path).image
    return encode_with_header_downsampled(image, dim)
