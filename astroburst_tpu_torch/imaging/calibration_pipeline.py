"""Batch calibration pipeline (counterpart of
astroburst_tpu/imaging/calibration_pipeline.py).

Reference: src-tauri/src/core/imaging/calibration_pipeline.rs —
per-channel light calibration (bias/dark/flat masters), optional
per-frame mean normalization, sigma-clipped mean stack (median/MAD
every iteration, strict z bounds, σ<1e-10 and no-removal early stops),
per-frame rejection counts, min-max channel normalization, optional
RGB merge of the first three channel masters.

The clip is not ``stacking/clip.sigma_clip_core`` (nor kernel K3): it
starts from every value, NaN and ±inf included, takes median/MAD on
every iteration, keeps a pixel active only with ≥ 3 values and counts
rejections per frame. Median and MAD are selected exactly, as the JAX
package selects them: ``torch.sort`` over the frame axis (masked values
as +inf, NaN after +inf in both sorts), then sorted index ``cnt // 2``.
Plain torch: the JAX package runs none of this in a Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.stacking.calibration import (CalibrationConfig,
                                                       calibrate_image)


@dataclass
class BatchStackConfig:
    sigma_low: float = 2.5
    sigma_high: float = 3.0
    max_iterations: int = 5
    normalize_before_stack: bool = True


@dataclass
class ChannelInput:
    label: str
    lights: List  # list of [H, W] tensors


@dataclass
class BatchChannelStats:
    label: str
    lights_input: int
    lights_after_rejection: List[int]   # rejected values per frame
    mean: float
    stddev: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class BatchPipelineResult:
    master_channels: List[Tuple[str, torch.Tensor]]
    rgb: Optional[torch.Tensor]  # [3, H, W]
    stats: dict


def _select(sorted_stack: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """sorted_stack [N, H, W] at index rank [H, W] (rank < N)."""
    return torch.gather(sorted_stack, 0, rank[None])[0]


def _masked_median_mad_axis0(stack: torch.Tensor, mask: torch.Tensor):
    """(median, mad) per pixel with select_nth semantics: sorted index
    cnt // 2 of the masked values, no even averaging (combine.rs:37-48)."""
    rank = mask.sum(dim=0) // 2
    inf = torch.tensor(float("inf"), device=stack.device)
    med = _select(torch.sort(torch.where(mask, stack, inf), dim=0).values,
                  rank)
    devs = torch.where(mask, torch.abs(stack - med), inf)
    mad = _select(torch.sort(devs, dim=0).values, rank)
    return med, mad


def sigma_clipped_mean_stack(stack: torch.Tensor, sigma_low: float,
                             sigma_high: float, max_iter: int):
    """All-iterations median/MAD clip with strict bounds
    (calibration_pipeline.rs:317-377). Returns (mean [H, W],
    per-frame rejection counts [N] int64)."""
    n = stack.shape[0]
    mask = torch.ones(stack.shape, dtype=torch.bool, device=stack.device)
    stopped = torch.zeros(stack.shape[1:], dtype=torch.bool,
                          device=stack.device)
    for _ in range(max_iter):
        cnt = mask.sum(dim=0)
        med, mad = _masked_median_mad_axis0(stack, mask)
        sigma = mad * MAD_TO_SIGMA
        active = (cnt >= 3) & ~stopped & (sigma >= 1e-10)
        stopped = stopped | (sigma < 1e-10)
        z = (stack - med) / torch.clamp(sigma, min=1e-30)
        keep = (z > -sigma_low) & (z < sigma_high)
        new_mask = torch.where(active[None], mask & keep, mask)
        removed = cnt - new_mask.sum(dim=0)
        stopped = stopped | (active & (removed == 0))
        mask = new_mask
    final_cnt = mask.sum(dim=0)
    # frame-ordered sum: the same order on every device
    total = torch.zeros_like(stack[0])
    for k in range(n):
        total = total + torch.where(mask[k], stack[k], 0.0)
    mean = total / torch.clamp(final_cnt.to(torch.float32), min=1.0)
    mean = torch.where(final_cnt > 0, mean, 0.0)
    rejected_per_frame = (~mask).sum(dim=(1, 2))
    return mean, rejected_per_frame


def _normalize_channel(ch: torch.Tensor) -> torch.Tensor:
    """Raw min-max normalize (calibration_pipeline.rs:286-303)."""
    mn = torch.min(ch)
    rng = torch.max(ch) - mn
    out = torch.clamp((ch - mn) / torch.clamp(rng, min=1e-30), 0.0, 1.0)
    return torch.where(rng < 1e-10, torch.zeros_like(ch), out)


def _mean_normalize_frame(frame: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(frame)
    return torch.where(mean > 0, frame / torch.clamp(mean, min=1e-30),
                       frame)


def run_batch_pipeline(channels: Sequence[ChannelInput],
                       masters: CalibrationConfig = CalibrationConfig(),
                       config: BatchStackConfig = BatchStackConfig()
                       ) -> BatchPipelineResult:
    """calibration_pipeline.rs:120-194, on the lights' device. The
    channel mean and stddev are numpy's f32 figures of the fetched
    master, as in the JAX package (population std)."""
    if not channels:
        raise InvalidInput("No channels provided")
    master_channels: List[Tuple[str, torch.Tensor]] = []
    channel_stats: List[BatchChannelStats] = []
    for ch in channels:
        if not ch.lights:
            raise InvalidInput(f"Channel '{ch.label}' has no light frames")
        calibrated = [calibrate_image(light, masters) for light in ch.lights]
        if config.normalize_before_stack:
            calibrated = [_mean_normalize_frame(f) for f in calibrated]
        master, rejected = sigma_clipped_mean_stack(
            torch.stack(calibrated), config.sigma_low, config.sigma_high,
            config.max_iterations)
        del calibrated
        master = _normalize_channel(master)
        master_channels.append((ch.label, master))
        m = master.cpu().numpy()
        channel_stats.append(BatchChannelStats(
            label=ch.label, lights_input=len(ch.lights),
            lights_after_rejection=rejected.tolist(),
            mean=float(m.mean()), stddev=float(m.std())))

    rgb = None
    if len(master_channels) >= 3:
        dims = [tuple(m.shape) for _, m in master_channels[:3]]
        if len(set(dims)) == 1:
            rgb = torch.stack([m for _, m in master_channels[:3]])

    return BatchPipelineResult(
        master_channels=master_channels, rgb=rgb,
        stats={
            "bias_combined": 1 if masters.master_bias is not None else 0,
            "darks_combined": 1 if masters.master_dark is not None else 0,
            "flats_combined": 1 if masters.master_flat is not None else 0,
            "channels": [s.to_dict() for s in channel_stats],
        })
