"""Compose commands (counterpart of astroburst_tpu/api/compose.py;
reference: src-tauri/src/cmd/compose/): the RGB compose with its
restretch and cache commands, the wizard's blend, align, crop and
export commands, and its colour commands (white balance and SCNR).

Each command resolves ``device`` first (``cuda_device()`` when None,
which raises where there is no card). Files are decoded onto that
device; the composite and wizard planes are read from the cache for
that device, and planes held for another device count as missing
(``CacheMiss``). Alignment is one ``align_pair`` per target: phase
correlation reaches kernels K1 and K2; the affine method on the card
takes the fused chain (K10, K11, K12 and the chain's scans), with the
reference's stars detected once for all targets
(``_shared_ref_stars``), as the JAX package does on its TPU; on the
CPU it takes the host chain.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.alignment import fused_chain
from astroburst_tpu_torch.alignment.pair import align_pair_with_label
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM, Timer,
                                             load_cached, load_cached_many,
                                             load_from_cache_or_disk,
                                             load_many_from_cache_or_disk)
from astroburst_tpu_torch.api.processing import _write_fits
from astroburst_tpu_torch.compose.channel_blend import blend_channels
from astroburst_tpu_torch.compose.lrgb import apply_lrgb
from astroburst_tpu_torch.compose.rgb import process_rgb
from astroburst_tpu_torch.compose.white_balance import select_wb_reference
from astroburst_tpu_torch.dtypes import (AlignMethod, RgbComposeConfig,
                                         StfParams)
from astroburst_tpu_torch.errors import CacheMiss, InvalidInput
from astroburst_tpu_torch.imaging.resample import resample_image
from astroburst_tpu_torch.imaging.scnr import apply_scnr
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir

AUTO_CROP_THRESHOLD = 1e-6  # crop.rs:12


def compose_rgb_cmd(output_dir: str = "", l_path: Optional[str] = None,
                    r_path: Optional[str] = None,
                    g_path: Optional[str] = None,
                    b_path: Optional[str] = None,
                    auto_stretch: Optional[bool] = None,
                    linked_stf: Optional[bool] = None,
                    align: Optional[bool] = None,
                    align_method: Optional[str] = None,
                    wb_mode: Optional[str] = None,
                    wb_r: Optional[float] = None,
                    wb_g: Optional[float] = None,
                    wb_b: Optional[float] = None,
                    scnr_enabled: Optional[bool] = None,
                    scnr_method: Optional[str] = None,
                    scnr_amount: Optional[float] = None,
                    lrgb_lightness: Optional[float] = None,
                    lrgb_chrominance: Optional[float] = None, *,
                    device: Optional[torch.device] = None) -> dict:
    """The full compose command (cmd/compose/rgb.rs:43): process_rgb,
    ORIG + KEY seeded with the pre-stretch planes, optional LRGB, the
    RGB preview."""
    with trace.span("api.compose_rgb"):
        t0 = Timer()
        device = device_or_cuda(device)
        out_dir = resolve_output_dir(output_dir)
        given = [p for p in (l_path, r_path, g_path, b_path) if p]
        loaded = dict(zip(given, load_cached_many(given, device=device)))
        l_entry, r_entry, g_entry, b_entry = (
            loaded[p] if p else None
            for p in (l_path, r_path, g_path, b_path))

        config = RgbComposeConfig(
            white_balance=helpers.parse_wb(wb_mode, wb_r, wb_g, wb_b),
            auto_stretch=auto_stretch if auto_stretch is not None else True,
            linked_stf=linked_stf if linked_stf is not None else False,
            align=align if align is not None else True,
            align_method=helpers.parse_align_method(align_method),
            scnr=helpers.parse_scnr_config(scnr_enabled, scnr_method,
                                           scnr_amount, None))

        processed = process_rgb(
            r_entry.image if r_entry else None,
            g_entry.image if g_entry else None,
            b_entry.image if b_entry else None, config)

        helpers.insert_composite_and_orig(
            processed.pre_stretch_r, processed.pre_stretch_g,
            processed.pre_stretch_b, processed.stats_wb_r,
            processed.stats_wb_g, processed.stats_wb_b)

        lrgb_applied = False
        r_img, g_img, b_img = processed.r, processed.g, processed.b
        if l_entry is not None:
            l_data = resample_image(l_entry.image, processed.rows,
                                    processed.cols)
            if config.auto_stretch:
                l_stats = compute_image_stats(l_data)
                l_data = apply_stf_f32(l_data, auto_stf(l_stats), l_stats)
            r_img, g_img, b_img = apply_lrgb(
                l_data, r_img, g_img, b_img,
                lrgb_lightness if lrgb_lightness is not None else 1.0,
                lrgb_chrominance if lrgb_chrominance is not None else 1.0)
            lrgb_applied = True

        png_path = helpers.composite_png_path(out_dir)
        with trace.span("compose.preview"):
            helpers.render_rgb_preview(r_img, g_img, b_img, png_path,
                                       MAX_PREVIEW_DIM)
        resampled = bool(processed.dimension_info and
                         processed.dimension_info.resampled)
        return {
            C.RES_PNG_PATH: png_path,
            C.RES_DIMENSIONS: [processed.cols, processed.rows],
            C.RES_SCNR_APPLIED: processed.scnr_applied,
            C.RES_OFFSET_G: list(processed.offset_g),
            C.RES_OFFSET_B: list(processed.offset_b),
            C.RES_DIMENSION_INFO: (processed.dimension_info.to_dict()
                                   if processed.dimension_info else None),
            C.RESAMPLED: resampled,
            C.LRGB_APPLIED: lrgb_applied,
            C.STF_R: processed.stf_r.to_dict(),
            C.STF_G: processed.stf_g.to_dict(),
            C.STF_B: processed.stf_b.to_dict(),
            C.RES_STATS_R: helpers.stats_brief(processed.stats_r),
            C.RES_STATS_G: helpers.stats_brief(processed.stats_g),
            C.RES_STATS_B: helpers.stats_brief(processed.stats_b),
            C.RES_ELAPSED_MS: t0.elapsed_ms(),
        }


def restretch_composite_cmd(output_dir: str,
                            shadow_r: float, midtone_r: float,
                            highlight_r: float,
                            shadow_g: float, midtone_g: float,
                            highlight_g: float,
                            shadow_b: float, midtone_b: float,
                            highlight_b: float,
                            scnr_enabled: Optional[bool] = None,
                            scnr_method: Optional[str] = None,
                            scnr_amount: Optional[float] = None, *,
                            device: Optional[torch.device] = None) -> dict:
    """Re-render KEY with per-channel STF (cmd/compose/rgb.rs:208)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    try:
        er, eg, eb = helpers.load_composite_rgb(device)
    except CacheMiss:
        raise InvalidInput("Composite not in cache. Please recompose first.")
    planes = [apply_stf_f32(e.image, StfParams(s, m, h), e.stats)
              for e, (s, m, h) in zip(
                  (er, eg, eb),
                  [(shadow_r, midtone_r, highlight_r),
                   (shadow_g, midtone_g, highlight_g),
                   (shadow_b, midtone_b, highlight_b)])]
    cfg = helpers.parse_scnr_config(scnr_enabled, scnr_method, scnr_amount,
                                    None)
    if cfg is not None:
        planes = list(apply_scnr(*planes, cfg))
    png_path = helpers.composite_png_path(out_dir)
    helpers.render_rgb_preview(planes[0], planes[1], planes[2], png_path,
                               MAX_PREVIEW_DIM)
    return {C.RES_PNG_PATH: png_path, C.RES_ELAPSED_MS: t0.elapsed_ms()}


def clear_composite_cache_cmd(*, device: Optional[torch.device] = None
                              ) -> None:
    """Drop the six composite planes (cmd/compose/rgb.rs:244)."""
    device_or_cuda(device)
    for key in (C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B,
                C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B):
        GLOBAL_IMAGE_CACHE.remove(key)


def update_composite_channel_cmd(channel: str, path: str, *,
                                 device: Optional[torch.device] = None
                                 ) -> dict:
    """Swap one composite channel, ORIG and KEY one tensor
    (cmd/compose/rgb.rs:255)."""
    t0 = Timer()
    device = device_or_cuda(device)
    ch = channel.lower()
    keys = {"r": (C.COMPOSITE_ORIG_R, C.COMPOSITE_KEY_R),
            "g": (C.COMPOSITE_ORIG_G, C.COMPOSITE_KEY_G),
            "b": (C.COMPOSITE_ORIG_B, C.COMPOSITE_KEY_B)}.get(ch)
    if keys is None:
        raise InvalidInput(f"Unknown channel '{channel}' (want r/g/b)")
    entry = load_cached(path, device)
    orig = GLOBAL_IMAGE_CACHE.insert(keys[0], entry.image,
                                     stats=entry.stats)
    GLOBAL_IMAGE_CACHE.insert(keys[1], orig.image, stats=entry.stats)
    return {C.RES_CHANNEL: ch, C.RES_PATH: path,
            C.RES_ELAPSED_MS: t0.elapsed_ms()}


def blend_channels_cmd(channel_paths: Sequence[str],
                       weights: Sequence[dict], output_dir: str = "",
                       preset: Optional[str] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """Resample → matrix blend → ORIG + KEY → linked auto-STF preview
    (cmd/compose/blend.rs:129)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    if not channel_paths:
        raise InvalidInput("No channel paths provided")
    entries = load_many_from_cache_or_disk(channel_paths, device=device)
    max_rows = max(int(e.image.shape[0]) for e in entries)
    max_cols = max(int(e.image.shape[1]) for e in entries)
    planes = [resample_image(e.image, max_rows, max_cols) for e in entries]

    blend_weights = []
    for w in weights:
        idx = w.get("channelIdx", w.get("channel_idx"))
        if idx is None:
            continue
        blend_weights.append({
            "channel_idx": int(idx),
            "r_weight": float(w.get("r", w.get("r_weight", 0.0))),
            "g_weight": float(w.get("g", w.get("g_weight", 0.0))),
            "b_weight": float(w.get("b", w.get("b_weight", 0.0)))})

    r, g, b = blend_channels(planes, blend_weights)
    stats_r = compute_image_stats(r)
    stats_g = compute_image_stats(g)
    stats_b = compute_image_stats(b)
    helpers.insert_composite_and_orig(r, g, b, stats_r, stats_g, stats_b)

    linked = helpers.compute_linked_stf(stats_r, stats_g, stats_b)
    png_path = helpers.composite_png_path(out_dir)
    helpers.render_rgb_preview_with_stf(
        r, g, b, linked, linked, linked, stats_r, stats_g, stats_b,
        png_path, MAX_PREVIEW_DIM)
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [max_cols, max_rows],
        C.RES_CHANNEL_COUNT: len(channel_paths),
        C.RES_BLEND_PRESET: preset or "",
        C.RES_STATS_R: helpers.stats_brief(stats_r),
        C.RES_STATS_G: helpers.stats_brief(stats_g),
        C.RES_STATS_B: helpers.stats_brief(stats_b),
        C.RES_AUTO_STF: helpers.stf_json(linked),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _bin_ids(bin_ids: Optional[Sequence[str]], n: int) -> list:
    ids = list(bin_ids) if bin_ids else []
    return [ids[i] if i < len(ids) else f"ch{i}" for i in range(n)]


def _shared_ref_stars(ref_image: torch.Tensor, method, n_targets: int,
                      rows: int, cols: int):
    """The reference channel's stars, detected once when several targets
    align to it through the fused chain (``fused_chain.detect_ref_stars``);
    None otherwise, and ``align_pair`` then detects them itself."""
    if (n_targets < 2 or method != AlignMethod.AFFINE
            or not fused_chain.takes_fused_chain(ref_image)
            or min(rows, cols) < 16):
        return None
    return fused_chain.detect_ref_stars(ref_image)


def align_channels_cmd(paths: Sequence[str], output_dir: str = "",
                       align_method: Optional[str] = None,
                       bin_ids: Optional[Sequence[str]] = None,
                       persist_to_disk: Optional[bool] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """Align every channel to the first; the results go to the wizard's
    cache keys (cmd/compose/blend.rs:226, constants.rs:266)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    if len(paths) < 2:
        raise InvalidInput("Need at least 2 channels to align")
    method = helpers.parse_align_method(align_method)
    write_disk = bool(persist_to_disk)

    entries = load_many_from_cache_or_disk(paths, device=device)
    ref_entry = entries[0]
    rows, cols = (int(d) for d in ref_entry.image.shape)
    ref_stars = _shared_ref_stars(ref_entry.image, method, len(paths) - 1,
                                  rows, cols)
    results = []
    cache_keys = []
    for i, bin_id in enumerate(_bin_ids(bin_ids, len(paths))):
        key = C.wizard_aligned_key(bin_id)
        cache_keys.append(key)
        if i == 0:
            GLOBAL_IMAGE_CACHE.insert(key, ref_entry.image,
                                      stats=ref_entry.stats,
                                      header=ref_entry.header)
            results.append({C.RES_CHANNEL: bin_id,
                            C.RES_OFFSET: [0.0, 0.0],
                            C.RES_CONFIDENCE: 1.0, "method": "reference",
                            "cache_key": key})
            continue
        entry = entries[i]
        res = align_pair_with_label(ref_entry.image, entry.image, method,
                                    rows, cols, bin_id, ref_stars=ref_stars)
        GLOBAL_IMAGE_CACHE.insert(key, res.aligned,
                                  stats=compute_image_stats(res.aligned),
                                  header=entry.header)
        if write_disk:
            _write_fits(os.path.join(out_dir, f"aligned_{bin_id}.fits"),
                        res.aligned, entry.header)
        results.append({
            C.RES_CHANNEL: bin_id,
            C.RES_OFFSET: [float(res.offset[0]), float(res.offset[1])],
            C.RES_CONFIDENCE: float(res.confidence),
            "method": res.method_used,
            "inliers": res.inliers,
            "residual": res.residual_px,
            "cache_key": key,
        })
    return {
        C.CHANNELS: results,
        C.RES_CACHE_KEYS: cache_keys,
        C.ALIGN_METHOD: method.value,
        C.DIMENSIONS: [cols, rows],
        C.RES_PERSIST_TO_DISK: write_disk,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def detect_valid_region(image: torch.Tensor, threshold: float):
    """(top, bottom, left, right) of the pixels with |x| > threshold
    (crop.rs:14-62; NaN is not valid): the row and column ``any`` run on
    the plane's device, and only those two boolean vectors are fetched.
    (0, 0, 0, 0) when no pixel is valid."""
    mask = torch.abs(image) > threshold
    rows_any, cols_any = np.split(
        torch.cat([mask.any(dim=1), mask.any(dim=0)]).cpu().numpy(),
        [int(image.shape[0])])
    if not rows_any.any():
        return 0, 0, 0, 0
    top = int(np.argmax(rows_any))
    bottom = int(len(rows_any) - np.argmax(rows_any[::-1]))
    left = int(np.argmax(cols_any))
    right = int(len(cols_any) - np.argmax(cols_any[::-1]))
    return top, bottom, left, right


def crop_channels_cmd(paths: Sequence[str], output_dir: str = "",
                      bin_ids: Optional[Sequence[str]] = None, *,
                      device: Optional[torch.device] = None) -> dict:
    """Intersect the channels' valid regions and crop every channel to
    it (cmd/compose/crop.rs:74)."""
    t0 = Timer()
    device = device_or_cuda(device)
    resolve_output_dir(output_dir)
    if not paths:
        raise InvalidInput("No channel paths provided")
    entries = load_many_from_cache_or_disk(paths, device=device)
    regions = [detect_valid_region(e.image, AUTO_CROP_THRESHOLD)
               for e in entries]
    top = max(r[0] for r in regions)
    bottom = min(r[1] for r in regions)
    left = max(r[2] for r in regions)
    right = min(r[3] for r in regions)
    if bottom <= top or right <= left:
        raise InvalidInput("No common valid region across channels")
    cache_keys = []
    for e, bin_id in zip(entries, _bin_ids(bin_ids, len(paths))):
        key = C.wizard_cropped_key(bin_id)
        # a copy: the kernels and the stats read the plane later
        cropped = e.image[top:bottom, left:right].contiguous()
        GLOBAL_IMAGE_CACHE.insert(key, cropped,
                                  stats=compute_image_stats(cropped),
                                  header=e.header)
        cache_keys.append(key)
    return {
        C.RES_CACHE_KEYS: cache_keys,
        "crop_region": {"top": top, "bottom": bottom, "left": left,
                        "right": right},
        C.RES_OUTPUT_DIMS: [right - left, bottom - top],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def export_aligned_channels_cmd(paths: Sequence[str], output_dir: str = "",
                                align_method: Optional[str] = None, *,
                                device: Optional[torch.device] = None
                                ) -> dict:
    """Align every channel to the first and write each as FITS, its
    CRPIX moved by the offset (cmd/compose/blend.rs:48, :20-30)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    if len(paths) < 2:
        raise InvalidInput("Need at least 2 channels to align")
    method = helpers.parse_align_method(align_method)
    ref_entry = load_from_cache_or_disk(paths[0], device)
    rows, cols = (int(d) for d in ref_entry.image.shape)
    ref_stars = _shared_ref_stars(ref_entry.image, method, len(paths) - 1,
                                  rows, cols)
    exported = []
    for i, p in enumerate(paths):
        stem = os.path.splitext(os.path.basename(p))[0]
        out_path = os.path.join(out_dir, f"{stem}_aligned.fits")
        if i == 0:
            _write_fits(out_path, ref_entry.image, ref_entry.header)
            exported.append({C.RES_PATH: out_path, C.RES_OFFSET: [0.0, 0.0]})
            continue
        entry = load_from_cache_or_disk(p, device)
        res = align_pair_with_label(ref_entry.image, entry.image, method,
                                    rows, cols, stem, ref_stars=ref_stars)
        header = entry.header.copy() if entry.header else None
        if header is not None:
            crpix1 = header.get_f64("CRPIX1")
            crpix2 = header.get_f64("CRPIX2")
            if crpix1 is not None:
                header.set_f64("CRPIX1", crpix1 - res.offset[1])
            if crpix2 is not None:
                header.set_f64("CRPIX2", crpix2 - res.offset[0])
        _write_fits(out_path, res.aligned, header)
        exported.append({C.RES_PATH: out_path,
                         C.RES_OFFSET: [float(res.offset[0]),
                                        float(res.offset[1])],
                         C.RES_CONFIDENCE: float(res.confidence)})
    return {
        C.CHANNELS: exported,
        C.ALIGN_METHOD: method.value,
        C.DIMENSIONS: [cols, rows],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def calibrate_and_scnr_cmd(output_dir: str, r_factor: float, g_factor: float,
                           b_factor: float,
                           scnr_enabled: Optional[bool] = None,
                           scnr_method: Optional[str] = None,
                           scnr_amount: Optional[float] = None,
                           scnr_preserve_luminance: Optional[bool] = None, *,
                           device: Optional[torch.device] = None) -> dict:
    """ORIG × WB → SCNR → KEY, idempotent (cmd/compose/color.rs:98).
    Each factor is floored at 1e-6 and rounded to f32; after SCNR, G's
    stats are taken again, and R's and B's only when it preserves the
    luminance (it changes them only then)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    try:
        orig_r, orig_g, orig_b = helpers.load_composite_orig_rgb(device)
    except CacheMiss:
        raise InvalidInput("No original composite. Run Blend first.")
    rf = max(float(r_factor), 1e-6)
    gf = max(float(g_factor), 1e-6)
    bf = max(float(b_factor), 1e-6)
    r = orig_r.image * rf
    g = orig_g.image * gf
    b = orig_b.image * bf
    stats_r = compute_image_stats(r)
    stats_g = compute_image_stats(g)
    stats_b = compute_image_stats(b)

    cfg = helpers.parse_scnr_config(scnr_enabled, scnr_method, scnr_amount,
                                    scnr_preserve_luminance)
    scnr_applied = False
    if cfg is not None and cfg.amount > 1e-7:
        r, g, b = apply_scnr(r, g, b, cfg)
        if cfg.preserve_luminance:
            stats_r = compute_image_stats(r)
            stats_b = compute_image_stats(b)
        stats_g = compute_image_stats(g)
        scnr_applied = True

    linked = helpers.compute_linked_stf(stats_r, stats_g, stats_b)
    png_path = helpers.composite_png_path(out_dir)
    helpers.render_rgb_preview_with_stf(r, g, b, linked, linked, linked,
                                        stats_r, stats_g, stats_b, png_path,
                                        MAX_PREVIEW_DIM)
    helpers.insert_composite_rgb(r, g, b, stats_r, stats_g, stats_b)
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_WB_APPLIED: True,
        C.RES_R_FACTOR: r_factor,
        C.RES_G_FACTOR: g_factor,
        C.RES_B_FACTOR: b_factor,
        C.RES_SCNR_APPLIED: scnr_applied,
        C.RES_AUTO_STF: helpers.stf_json(linked),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def compute_auto_wb_cmd(*, device: Optional[torch.device] = None) -> dict:
    """Stability-reference WB factors of ORIG, else KEY
    (cmd/compose/color.rs:188)."""
    device = device_or_cuda(device)
    er, eg, eb = helpers.load_orig_or_composite(device)
    r, g, b = select_wb_reference(er.stats, eg.stats, eb.stats)
    return {C.RES_R_FACTOR: r, C.RES_G_FACTOR: g, C.RES_B_FACTOR: b}


def reset_wb_cmd(output_dir: str, *,
                 device: Optional[torch.device] = None) -> dict:
    """ORIG → KEY, O(1) (cmd/compose/color.rs:52): KEY becomes the ORIG
    tensors themselves, and no command writes into a cached plane."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    try:
        orig_r, orig_g, orig_b = helpers.load_composite_orig_rgb(device)
    except CacheMiss:
        raise InvalidInput("No original composite. Run Blend first.")
    linked = helpers.compute_linked_stf(orig_r.stats, orig_g.stats,
                                        orig_b.stats)
    png_path = helpers.composite_png_path(out_dir)
    helpers.render_rgb_preview_with_stf(
        orig_r.image, orig_g.image, orig_b.image, linked, linked, linked,
        orig_r.stats, orig_g.stats, orig_b.stats, png_path, MAX_PREVIEW_DIM)
    helpers.insert_composite_rgb(orig_r.image, orig_g.image, orig_b.image,
                                 orig_r.stats, orig_g.stats, orig_b.stats)
    return {
        C.RES_PNG_PATH: png_path,
        "reset": True,
        C.RES_R_FACTOR: 1.0,
        C.RES_G_FACTOR: 1.0,
        C.RES_B_FACTOR: 1.0,
        C.RES_AUTO_STF: helpers.stf_json(linked),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
