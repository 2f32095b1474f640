"""Per-channel drizzle → RGB assembly (counterpart of
astroburst_tpu/compose/drizzle_rgb.py; reference:
src-tauri/src/core/compose/drizzle_rgb.rs).

Drizzle each channel's frame list (``drizzle_stack``: kernels K1, K2
and K7), crop to the common dims, white balance (auto, manual or
none), linked or per-channel auto STF, stretch, optional SCNR. The
linked STF's merge here is (r + g + b) / 3.0, as the JAX package
writes it (XLA compiles it to a multiply by 1/3, ROADMAP C27);
``compose/rgb.py`` multiplies by 1/3, and each keeps its own form.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional, Sequence, Tuple

import torch

from astroburst_tpu_torch.compose.white_balance import select_wb_reference
from astroburst_tpu_torch.dtypes import (AutoStfConfig, DrizzleConfig,
                                         ImageStats, ScnrConfig, StfParams,
                                         WhiteBalance, WhiteBalanceMode)
from astroburst_tpu_torch.imaging.scnr import apply_scnr
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.device import as_f32_all
from astroburst_tpu_torch.stacking.drizzle import DrizzleResult, drizzle_stack


@dataclass
class DrizzleRgbConfig:
    drizzle: DrizzleConfig = dc_field(default_factory=DrizzleConfig)
    white_balance: WhiteBalance = dc_field(default_factory=WhiteBalance)
    auto_stretch: bool = True
    linked_stf: bool = True
    scnr: Optional[ScnrConfig] = None


@dataclass
class ProcessedDrizzleRgb:
    r_stretched: torch.Tensor
    g_stretched: torch.Tensor
    b_stretched: torch.Tensor
    r_linear: torch.Tensor
    g_linear: torch.Tensor
    b_linear: torch.Tensor
    stf_r: StfParams
    stf_g: StfParams
    stf_b: StfParams
    stats_r: ImageStats
    stats_g: ImageStats
    stats_b: ImageStats
    wb: Tuple[float, float, float]
    scnr_applied: bool
    out_dims: Tuple[int, int]
    frame_counts: Dict[str, int]


def process_drizzle_rgb(r_image, g_image, b_image,
                        config: DrizzleRgbConfig = DrizzleRgbConfig()
                        ) -> ProcessedDrizzleRgb:
    """Assemble drizzled channel planes into a stretched RGB composite
    (drizzle_rgb.rs:41-150), on the planes' device (numpy planes go to
    ``cuda_device()``)."""
    present = [img for img in (r_image, g_image, b_image) if img is not None]
    if not present:
        raise ValueError("No drizzled channels provided")
    it = iter(as_f32_all(*present))
    planes = [None if img is None else next(it)
              for img in (r_image, g_image, b_image)]
    dev = next(p for p in planes if p is not None).device
    out_rows = min(int(p.shape[0]) for p in planes if p is not None)
    out_cols = min(int(p.shape[1]) for p in planes if p is not None)

    def crop_or_zero(img):
        if img is None:
            return torch.zeros((out_rows, out_cols), dtype=torch.float32,
                               device=dev)
        return img[:out_rows, :out_cols]

    r_img, g_img, b_img = (crop_or_zero(p) for p in planes)

    mode = config.white_balance.mode
    if mode == WhiteBalanceMode.AUTO:
        wb = select_wb_reference(compute_image_stats(r_img),
                                 compute_image_stats(g_img),
                                 compute_image_stats(b_img))
    elif mode == WhiteBalanceMode.MANUAL:
        wb = (config.white_balance.r, config.white_balance.g,
              config.white_balance.b)
    else:
        wb = (1.0, 1.0, 1.0)

    r_wb = r_img * wb[0]
    g_wb = g_img * wb[1]
    b_wb = b_img * wb[2]

    stf_cfg = AutoStfConfig()
    sr = compute_image_stats(r_wb)
    sg = compute_image_stats(g_wb)
    sb = compute_image_stats(b_wb)
    if config.auto_stretch:
        if config.linked_stf:
            merged = (r_wb + g_wb + b_wb) / 3.0
            pr = pg = pb = auto_stf(compute_image_stats(merged), stf_cfg)
        else:
            pr = auto_stf(sr, stf_cfg)
            pg = auto_stf(sg, stf_cfg)
            pb = auto_stf(sb, stf_cfg)
    else:
        pr = pg = pb = StfParams()

    r_s = apply_stf_f32(r_wb, pr, sr)
    g_s = apply_stf_f32(g_wb, pg, sg)
    b_s = apply_stf_f32(b_wb, pb, sb)

    scnr_applied = False
    if config.scnr is not None:
        r_s, g_s, b_s = apply_scnr(r_s, g_s, b_s, config.scnr)
        scnr_applied = True

    return ProcessedDrizzleRgb(
        r_stretched=r_s, g_stretched=g_s, b_stretched=b_s,
        r_linear=r_wb, g_linear=g_wb, b_linear=b_wb,
        stf_r=pr, stf_g=pg, stf_b=pb,
        stats_r=sr, stats_g=sg, stats_b=sb,
        wb=wb, scnr_applied=scnr_applied,
        out_dims=(out_rows, out_cols), frame_counts={})


def drizzle_rgb(r_frames: Sequence, g_frames: Sequence, b_frames: Sequence,
                config: DrizzleRgbConfig = DrizzleRgbConfig(),
                progress: Optional[object] = None
                ) -> Tuple[ProcessedDrizzleRgb, Dict[str, DrizzleResult]]:
    """Drizzle each channel, then assemble (drizzle_rgb.rs:159+)."""
    results: Dict[str, DrizzleResult] = {}
    planes = {}
    for name, frames in (("r", r_frames), ("g", g_frames), ("b", b_frames)):
        if frames:
            res = drizzle_stack(frames, config.drizzle, progress)
            results[name] = res
            planes[name] = res.image
            if progress is not None:
                progress.tick_with_stage(f"drizzled {name.upper()}")
        else:
            planes[name] = None
    out = process_drizzle_rgb(planes["r"], planes["g"], planes["b"], config)
    out.frame_counts = {k: v.frame_count for k, v in results.items()}
    return out, results
