"""Composite cache helpers, linked STF, stats payloads and preview
rendering (counterpart of astroburst_tpu/api/helpers.py; reference:
src-tauri/src/cmd/helpers.rs), and the SCNR parser of the tone
command and the compose parsers ``parse_wb`` and
``parse_align_method``.

Previews are downsampled in f32 on the plane's device, STF-mapped to
u8 there, and fetched once (all three planes of an RGB preview in one
transfer).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional, Tuple

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.dtypes import (AlignMethod, AutoStfConfig,
                                         ImageStats, ScnrConfig, ScnrMethod,
                                         StfParams, WhiteBalance,
                                         WhiteBalanceMode)
from astroburst_tpu_torch.errors import CacheMiss
from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
from astroburst_tpu_torch.io.png import save_gray_png, save_rgb_png
from astroburst_tpu_torch.ops.ipc import nearest_downsample
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE


def stats_json(stats: ImageStats) -> dict:
    """Short stats payload (helpers.rs:146-154)."""
    return {
        C.RES_MIN: stats.min,
        C.RES_MAX: stats.max,
        C.RES_MEAN: stats.mean,
        C.RES_SIGMA: stats.sigma,
        C.RES_MEDIAN: stats.median,
    }


def stats_json_full(stats: ImageStats) -> dict:
    """Stats payload incl. MAD (helpers.rs:156-165)."""
    d = stats_json(stats)
    d[C.RES_MAD] = stats.mad
    return d


def stf_json(stf: StfParams) -> dict:
    return stf.to_dict()


def insert_composite_and_orig(r, g, b, stats_r: ImageStats,
                              stats_g: ImageStats,
                              stats_b: ImageStats) -> None:
    """Seed ORIG (immutable blend output) and KEY (working copy) with the
    same device tensors — zero-copy like the reference's shared Arcs
    (helpers.rs:127-144)."""
    for key_orig, key_work, plane, st in [
        (C.COMPOSITE_ORIG_R, C.COMPOSITE_KEY_R, r, stats_r),
        (C.COMPOSITE_ORIG_G, C.COMPOSITE_KEY_G, g, stats_g),
        (C.COMPOSITE_ORIG_B, C.COMPOSITE_KEY_B, b, stats_b),
    ]:
        entry = GLOBAL_IMAGE_CACHE.insert(key_orig, plane, stats=st)
        # the same device tensor under both keys
        GLOBAL_IMAGE_CACHE.insert(key_work, entry.image, stats=st)


def compute_linked_stf_with_stats(
        stats_r: ImageStats, stats_g: ImageStats, stats_b: ImageStats,
        config: AutoStfConfig = AutoStfConfig()) -> Tuple[StfParams, ImageStats]:
    """Linked STF from merged channel statistics (helpers.rs:185-202)."""
    combined = ImageStats(
        min=min(stats_r.min, stats_g.min, stats_b.min),
        max=max(stats_r.max, stats_g.max, stats_b.max),
        mean=(stats_r.mean + stats_g.mean + stats_b.mean) / 3.0,
        median=(stats_r.median + stats_g.median + stats_b.median) / 3.0,
        sigma=math.sqrt((stats_r.sigma ** 2 + stats_g.sigma ** 2 +
                         stats_b.sigma ** 2) / 3.0),
        mad=(stats_r.mad + stats_g.mad + stats_b.mad) / 3.0,
        valid_count=stats_r.valid_count,
    )
    return auto_stf(combined, config), combined


def compute_linked_stf(stats_r, stats_g, stats_b,
                       config: AutoStfConfig = AutoStfConfig()) -> StfParams:
    return compute_linked_stf_with_stats(stats_r, stats_g, stats_b, config)[0]


def save_preview_png(u8_plane: torch.Tensor, path: str,
                     max_dim: int = 4096) -> None:
    """Downsample a u8 plane on its device, fetch it and save it as a
    mono preview. Prefer save_stf_preview_png when you have the f32
    plane."""
    small = nearest_downsample(u8_plane, max_dim)
    with trace.span("io.fetch"):
        host = small.cpu().numpy()
    save_gray_png(host, path)


def save_stf_preview_png(plane: torch.Tensor, stf: StfParams,
                         stats: ImageStats, path: str,
                         max_dim: int = 4096) -> None:
    """Nearest-downsample the f32 plane first, then STF-map and
    quantise (the STF is pointwise, so it commutes with subsampling),
    fetch the u8 preview and save it."""
    with trace.span("stats.stf"):
        u8 = apply_stf_u8(nearest_downsample(plane, max_dim), stf, stats)
    with trace.span("io.fetch"):
        host = u8.cpu().numpy()
    save_gray_png(host, path)


def _save_rgb_u8(planes, path: str) -> None:
    """Fetch three u8 planes of one shape in one transfer; save RGB."""
    with trace.span("io.fetch"):
        r, g, b = torch.stack(planes).cpu().numpy()
    save_rgb_png(r, g, b, path)


def render_rgb_preview_with_stf(r, g, b, stf_r: StfParams, stf_g: StfParams,
                                stf_b: StfParams, stats_r: ImageStats,
                                stats_g: ImageStats, stats_b: ImageStats,
                                path: str, max_dim: int = 4096) -> None:
    """Downsample each channel (f32, on its device), STF-map, save RGB
    PNG (helpers.rs:264-322). Downsample first: see
    save_stf_preview_png."""
    _save_rgb_u8([apply_stf_u8(nearest_downsample(plane, max_dim), stf, st)
                  for plane, stf, st in ((r, stf_r, stats_r),
                                         (g, stf_g, stats_g),
                                         (b, stf_b, stats_b))], path)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] → u8 with round-half-even ×255; non-finite → 0."""
    clean = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(torch.round(clean * 255.0), 0, 255).to(torch.uint8)


def render_rgb_preview(r_stretched, g_stretched, b_stretched, path: str,
                       max_dim: int = 4096) -> None:
    """Assume planes already stretched to [0,1]; quantize + save
    (helpers.rs:204-262)."""
    _save_rgb_u8([_to_u8(nearest_downsample(p, max_dim))
                  for p in (r_stretched, g_stretched, b_stretched)], path)


def stats_brief(stats: ImageStats) -> dict:
    """The 4-field stats payload used by compose responses."""
    return {C.RES_MEDIAN: stats.median, C.RES_MEAN: stats.mean,
            C.RES_MIN: stats.min, C.RES_MAX: stats.max}


def composite_png_path(output_dir: str) -> str:
    """Timestamped composite preview path; stale composites removed
    (cmd/compose/rgb.rs:19-33)."""
    try:
        for name in os.listdir(output_dir):
            if name.startswith("rgb_composite") and name.endswith(".png"):
                try:
                    os.remove(os.path.join(output_dir, name))
                except OSError:
                    pass
    except OSError:
        pass
    return os.path.join(output_dir, f"rgb_composite_{int(time.time()*1000)}.png")


def _require(key: str, device=None):
    entry = GLOBAL_IMAGE_CACHE.get(key, device)
    if entry is None or entry.stats is None:
        raise CacheMiss(f"cache key not found: {key}")
    return entry


def load_composite_rgb(device=None):
    """KEY working planes (helpers.rs load_composite_rgb); with
    ``device`` given, planes on another device count as missing."""
    return (_require(C.COMPOSITE_KEY_R, device),
            _require(C.COMPOSITE_KEY_G, device),
            _require(C.COMPOSITE_KEY_B, device))


def load_composite_orig_rgb(device=None):
    """ORIG immutable planes (``device`` as in load_composite_rgb)."""
    return (_require(C.COMPOSITE_ORIG_R, device),
            _require(C.COMPOSITE_ORIG_G, device),
            _require(C.COMPOSITE_ORIG_B, device))


def load_orig_or_composite(device=None):
    try:
        return load_composite_orig_rgb(device)
    except CacheMiss:
        return load_composite_rgb(device)


def insert_composite_rgb(r, g, b, stats_r, stats_g, stats_b) -> None:
    """Replace only the KEY working planes (color pipeline writes)."""
    GLOBAL_IMAGE_CACHE.insert(C.COMPOSITE_KEY_R, r, stats=stats_r)
    GLOBAL_IMAGE_CACHE.insert(C.COMPOSITE_KEY_G, g, stats=stats_g)
    GLOBAL_IMAGE_CACHE.insert(C.COMPOSITE_KEY_B, b, stats=stats_b)


def parse_scnr_config(enabled: Optional[bool], method: Optional[str],
                      amount: Optional[float],
                      preserve_luminance: Optional[bool]
                      ) -> Optional[ScnrConfig]:
    """The SCNR request of a command, None when it is off
    (helpers.rs parse_scnr_config)."""
    if not enabled:
        return None
    return ScnrConfig(
        method=ScnrMethod.parse(method),
        amount=float(amount if amount is not None else C.DEFAULT_SCNR_AMOUNT),
        preserve_luminance=bool(preserve_luminance or False))


def parse_wb(mode: Optional[str], r: Optional[float], g: Optional[float],
             b: Optional[float]) -> WhiteBalance:
    """The white-balance request of a command: auto unless ``mode`` is
    manual (missing or zero factors read as 1) or none."""
    m = (mode or "auto").lower()
    if m == C.WB_MODE_MANUAL:
        return WhiteBalance(mode=WhiteBalanceMode.MANUAL, r=r or 1.0,
                            g=g or 1.0, b=b or 1.0)
    if m == C.WB_MODE_NONE:
        return WhiteBalance(mode=WhiteBalanceMode.NONE)
    return WhiteBalance(mode=WhiteBalanceMode.AUTO)


def parse_align_method(s: Optional[str]) -> AlignMethod:
    return AlignMethod.parse(s)
