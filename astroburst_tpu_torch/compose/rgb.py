"""Full RGB composition pipeline (counterpart of
astroburst_tpu/compose/rgb.py; reference:
src-tauri/src/core/compose/rgb.rs).

Dimension harmonization (resample to the largest dims, ratio cap 8×),
missing-channel synthesis (the mean of the others), G/B alignment to
the reference channel, white-balance multipliers, the linked STF from
the (R+G+B)/3 merge, the STF, SCNR; the pre-stretch linear planes and
their stats are kept (the ORIG side of the ORIG/KEY cache).

Alignment: on the card an affine compose with both G and B runs
both targets through the fused chain (``fused_chain.align_and_warp_many``)
with the reference's stars detected once and one host fetch, as the
JAX package does on its TPU; otherwise one ``align_pair`` per target.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from astroburst_tpu_torch.alignment import fused_chain
from astroburst_tpu_torch.alignment.pair import align_pair_with_label
from astroburst_tpu_torch.compose.white_balance import select_wb_reference
from astroburst_tpu_torch.constants import MAX_DIMENSION_RATIO
from astroburst_tpu_torch.dtypes import (AlignMethod, ImageStats,
                                         RgbComposeConfig, StfParams,
                                         WhiteBalanceMode)
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.resample import resample_image
from astroburst_tpu_torch.imaging.scnr import apply_scnr
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import as_f32, as_f32_all

log = logging.getLogger("astroburst_tpu_torch.align")


@dataclass
class DimensionInfo:
    original_r: Optional[Tuple[int, int]]
    original_g: Optional[Tuple[int, int]]
    original_b: Optional[Tuple[int, int]]
    target: Tuple[int, int]
    resampled: bool

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class ProcessedRgb:
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    rows: int
    cols: int
    stf_r: StfParams
    stf_g: StfParams
    stf_b: StfParams
    stats_r: ImageStats
    stats_g: ImageStats
    stats_b: ImageStats
    offset_g: Tuple[float, float]
    offset_b: Tuple[float, float]
    scnr_applied: bool
    dimension_info: Optional[DimensionInfo]
    pre_stretch_r: Optional[torch.Tensor] = None
    pre_stretch_g: Optional[torch.Tensor] = None
    pre_stretch_b: Optional[torch.Tensor] = None
    stats_wb_r: Optional[ImageStats] = None
    stats_wb_g: Optional[ImageStats] = None
    stats_wb_b: Optional[ImageStats] = None


def _dims(c) -> Optional[Tuple[int, int]]:
    return None if c is None else (int(c.shape[0]), int(c.shape[1]))


def harmonize_dimensions(r, g, b, max_ratio: float = MAX_DIMENSION_RATIO):
    """Resample mismatched channels to the largest dims (rgb.rs:42-128).
    Returns (r, g, b, rows, cols, DimensionInfo or None)."""
    dims = [_dims(c) for c in (r, g, b) if c is not None]
    if not dims:
        return r, g, b, 0, 0, None
    min_rows = min(d[0] for d in dims)
    min_cols = min(d[1] for d in dims)
    max_rows = max(d[0] for d in dims)
    max_cols = max(d[1] for d in dims)
    if (min_rows, min_cols) == (max_rows, max_cols):
        return r, g, b, max_rows, max_cols, None
    ratio = max(max_rows / max(min_rows, 1), max_cols / max(min_cols, 1))
    if ratio > max_ratio:
        raise InvalidInput(
            f"Channel dimension ratio {ratio:.1f}x exceeds "
            f"{max_ratio:.0f}x limit. Check channel assignments.")

    def wh(c):
        d = _dims(c)
        return None if d is None else (d[1], d[0])

    info = DimensionInfo(original_r=wh(r), original_g=wh(g),
                         original_b=wh(b), target=(max_cols, max_rows),
                         resampled=True)

    def fix(c):
        if c is None or _dims(c) == (max_rows, max_cols):
            return c
        return resample_image(c, max_rows, max_cols)

    return fix(r), fix(g), fix(b), max_rows, max_cols, info


def channel_or_synth(primary, alt1, alt2, rows: int, cols: int):
    """A missing channel is the mean of the others (rgb.rs:132-151)."""
    if primary is not None:
        return primary
    if alt1 is not None and alt2 is not None:
        return (alt1 + alt2) * 0.5
    if alt1 is not None:
        return alt1
    if alt2 is not None:
        return alt2
    return torch.zeros((rows, cols), dtype=torch.float32)


def _synth_all(r, g, b, rows: int, cols: int):
    return (channel_or_synth(r, g, b, rows, cols),
            channel_or_synth(g, r, b, rows, cols),
            channel_or_synth(b, r, g, rows, cols))


def align_rgb_channels(r, g, b, rows: int, cols: int, method):
    """Align G and B to the reference channel (rgb.rs:165-189): the
    first of R, G, B present. Returns (r, g, b, offset_g, offset_b)."""
    ref = r if r is not None else (g if g is not None else b)
    r_img, g_img, b_img = _synth_all(r, g, b, rows, cols)
    off_g = (0.0, 0.0)
    off_b = (0.0, 0.0)
    if (g is not None and b is not None and method == AlignMethod.AFFINE
            and min(rows, cols) >= 16):
        ref_t = as_f32(ref)
        if (fused_chain.takes_fused_chain(ref_t)
                and tuple(ref_t.shape) == (rows, cols)):
            # both aligns share the reference channel: its stars are
            # detected once, and both chains end in one info fetch
            ref_stars = fused_chain.detect_ref_stars(ref_t)
            (g_img, res_g), (b_img, res_b) = fused_chain.align_and_warp_many(
                ref_t, [g_img, b_img], ref_stars=ref_stars)
            for label, res in (("G", res_g), ("B", res_b)):
                log.info("%s alignment: %s, offset=(%.2f, %.2f), "
                         "inliers=%d", label, res.method,
                         res.transform.ty, res.transform.tx, res.inliers)
            return (r_img, g_img, b_img,
                    (res_g.transform.ty, res_g.transform.tx),
                    (res_b.transform.ty, res_b.transform.tx))
    if g is not None:
        res = align_pair_with_label(ref, g_img, method, rows, cols, "G")
        g_img, off_g = res.aligned, res.offset
    if b is not None:
        res = align_pair_with_label(ref, b_img, method, rows, cols, "B")
        b_img, off_b = res.aligned, res.offset
    return r_img, g_img, b_img, off_g, off_b


def _mul(img: torch.Tensor, m: float) -> torch.Tensor:
    return img if abs(m - 1.0) < 1e-7 else img * m


def process_rgb(r_channel, g_channel, b_channel,
                config: RgbComposeConfig = RgbComposeConfig()
                ) -> ProcessedRgb:
    """The full compose pipeline (rgb.rs:209-322) on the channels'
    device (numpy channels go to ``cuda_device()``)."""
    present = [c for c in (r_channel, g_channel, b_channel) if c is not None]
    if len(present) < 2:
        raise InvalidInput(
            f"Need at least 2 channels for RGB compose (got {len(present)})")
    it = iter(as_f32_all(*present))
    r, g, b = (None if c is None else next(it)
               for c in (r_channel, g_channel, b_channel))

    with trace.span("compose.harmonize"):
        r, g, b, rows, cols, dim_info = harmonize_dimensions(r, g, b)

    if config.align:
        with trace.span("compose.align"):
            r_img, g_img, b_img, off_g, off_b = align_rgb_channels(
                r, g, b, rows, cols, config.align_method)
    else:
        r_img, g_img, b_img = _synth_all(r, g, b, rows, cols)
        off_g = off_b = (0.0, 0.0)

    with trace.span("compose.color"):
        stats_r = compute_image_stats(r_img)
        stats_g = compute_image_stats(g_img)
        stats_b = compute_image_stats(b_img)

        mode = config.white_balance.mode
        if mode == WhiteBalanceMode.AUTO:
            wb = select_wb_reference(stats_r, stats_g, stats_b)
        elif mode == WhiteBalanceMode.MANUAL:
            wb = (config.white_balance.r, config.white_balance.g,
                  config.white_balance.b)
        else:
            wb = (1.0, 1.0, 1.0)

        r_img = _mul(r_img, wb[0])
        g_img = _mul(g_img, wb[1])
        b_img = _mul(b_img, wb[2])

        sr = compute_image_stats(r_img)
        sg = compute_image_stats(g_img)
        sb = compute_image_stats(b_img)
        if config.auto_stretch:
            if config.linked_stf:
                # the merge multiplies by 1/3 (drizzle_rgb divides by 3)
                st = compute_image_stats(
                    (r_img + g_img + b_img) * (1.0 / 3.0))
                pr = pg = pb = auto_stf(st, config.auto_stf)
            else:
                pr = auto_stf(sr, config.auto_stf)
                pg = auto_stf(sg, config.auto_stf)
                pb = auto_stf(sb, config.auto_stf)
        else:
            ident = StfParams(shadow=0.0, midtone=0.5, highlight=1.0)
            pr = config.stf_r or ident
            pg = config.stf_g or ident
            pb = config.stf_b or ident

        pre_r, pre_g, pre_b = r_img, g_img, b_img

        # the composite's STF (rgb.rs:195-208) has apply_stf_f32's
        # validity rule (finite and > 1e-7, else 0) and parameter scalars
        r_img = apply_stf_f32(r_img, pr, sr)
        g_img = apply_stf_f32(g_img, pg, sg)
        b_img = apply_stf_f32(b_img, pb, sb)

        scnr_applied = False
        if (config.scnr is not None
                and r_img.shape == g_img.shape == b_img.shape):
            r_img, g_img, b_img = apply_scnr(r_img, g_img, b_img,
                                             config.scnr)
            scnr_applied = True

    return ProcessedRgb(
        r=r_img, g=g_img, b=b_img, rows=rows, cols=cols,
        stf_r=pr, stf_g=pg, stf_b=pb,
        stats_r=stats_r, stats_g=stats_g, stats_b=stats_b,
        offset_g=off_g, offset_b=off_b, scnr_applied=scnr_applied,
        dimension_info=dim_info,
        pre_stretch_r=pre_r, pre_stretch_g=pre_g, pre_stretch_b=pre_b,
        stats_wb_r=sr, stats_wb_g=sg, stats_wb_b=sb)
