"""Calibration masters and light-frame calibration
(counterpart of astroburst_tpu/stacking/calibration.py).

Reference: src-tauri/src/core/stacking/calibration.rs — master
bias/dark/flat via per-pixel median combine (dark is bias-subtracted,
flat is bias/dark-subtracted then mean-normalized), then
``(raw − bias − r·dark) / flat`` with |flat| ≤ 1e-4 guarded and the
result clamped ≥ 0.

``create_master_bias``/``_dark``/``_flat`` take FITS paths, as the
JAX functions do: the frames are decoded through
``io/prefetch.DeviceLoader`` (into pinned memory on a CUDA device)
straight into one [N, H, W] stack on the device, bypassing the image
cache, then ``median_combine``d after subtracting the masters given
(and ``_mean_normalize``d for the flat). Plain elementwise torch and
``torch.sort``: the JAX package runs none of this in a Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.io.fits_reader import extract_image
from astroburst_tpu_torch.io.prefetch import prefetch_images
from astroburst_tpu_torch.runtime.device import device_or_cuda


@dataclass
class CalibrationConfig:
    master_bias: Optional[torch.Tensor] = None
    master_dark: Optional[torch.Tensor] = None
    master_flat: Optional[torch.Tensor] = None
    dark_exposure_ratio: float = 1.0


def median_combine(stack: torch.Tensor) -> torch.Tensor:
    """Per-pixel median over the finite values of [N, H, W]; empty → 0
    (calibration.rs:85-125, select_nth semantics: sorted index cnt // 2,
    no even averaging)."""
    finite = torch.isfinite(stack)
    cnt = finite.sum(dim=0)
    svals = torch.sort(torch.where(finite, stack, float("inf")), dim=0).values
    rank = torch.clamp(cnt // 2, max=stack.shape[0] - 1)
    med = torch.gather(svals, 0, rank[None])[0]
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def subtract_bias(image: torch.Tensor, master_bias: torch.Tensor):
    return image - master_bias


def subtract_dark(image: torch.Tensor, master_dark: torch.Tensor,
                  exposure_ratio: float = 1.0):
    return image - master_dark * exposure_ratio


def divide_flat(image: torch.Tensor, master_flat: torch.Tensor):
    """image / flat where the flat is finite and |flat| > 1e-4, else the
    image unchanged."""
    ok = torch.isfinite(master_flat) & (torch.abs(master_flat) > 1e-4)
    return torch.where(ok, image / torch.where(ok, master_flat, 1.0), image)


def calibrate_image(raw: torch.Tensor,
                    config: CalibrationConfig) -> torch.Tensor:
    """Full light calibration chain, clamped ≥ 0 (calibration.rs:47-83)."""
    v = raw
    if config.master_bias is not None:
        v = subtract_bias(v, config.master_bias)
    if config.master_dark is not None:
        v = subtract_dark(v, config.master_dark, config.dark_exposure_ratio)
    if config.master_flat is not None:
        v = divide_flat(v, config.master_flat)
    return torch.clamp(v, min=0.0)


def _mean_normalize(flat: torch.Tensor) -> torch.Tensor:
    """Normalize by the mean of finite-positive values; invalid pixels
    become 1.0 (calibration.rs:232-251)."""
    ok = torch.isfinite(flat) & (flat > 0.0)
    cnt = ok.sum().to(torch.float32)
    mean = torch.where(ok, flat, 0.0).sum() / torch.clamp(cnt, min=1.0)
    inv_mean = torch.where(torch.abs(mean) > 1e-10, 1.0 / mean,
                           torch.ones_like(mean))
    normalized = torch.where(ok, flat * inv_mean, 1.0)
    return torch.where(cnt > 0, normalized, flat)


def _load_stack(paths: Sequence[str],
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[N, H, W] f32 on ``device`` (default ``cuda_device()``) from FITS
    files, read as the JAX ``load_fits_image`` reads them (no ZIP or
    directory resolution, no image cache); each frame must have the
    first one's dims."""
    device = device_or_cuda(device)
    stack = None
    for i, img in enumerate(prefetch_images(paths, loader=extract_image,
                                            device=device)):
        frame = img.image
        if stack is None:
            stack = torch.empty((len(paths),) + tuple(frame.shape),
                                dtype=torch.float32, device=device)
        elif tuple(frame.shape) != tuple(stack.shape[1:]):
            raise InvalidInput(
                f"Dimension mismatch: expected {tuple(stack.shape[1:])}, "
                f"got {tuple(frame.shape)} ({paths[i]})")
        stack[i] = frame
    return stack


def create_master_bias(bias_paths: Sequence[str], *,
                       device: Optional[torch.device] = None
                       ) -> torch.Tensor:
    if not bias_paths:
        raise InvalidInput("No bias frames provided")
    return median_combine(_load_stack(bias_paths, device))


def create_master_dark(dark_paths: Sequence[str],
                       master_bias: Optional[torch.Tensor] = None, *,
                       device: Optional[torch.device] = None
                       ) -> torch.Tensor:
    if not dark_paths:
        raise InvalidInput("No dark frames provided")
    stack = _load_stack(dark_paths, device)
    if master_bias is not None:
        stack -= master_bias[None]
    return median_combine(stack)


def create_master_flat(flat_paths: Sequence[str],
                       master_bias: Optional[torch.Tensor] = None,
                       master_dark: Optional[torch.Tensor] = None, *,
                       device: Optional[torch.device] = None
                       ) -> torch.Tensor:
    if not flat_paths:
        raise InvalidInput("No flat frames provided")
    stack = _load_stack(flat_paths, device)
    if master_bias is not None:
        stack -= master_bias[None]
    if master_dark is not None:
        stack -= master_dark[None]
    return _mean_normalize(median_combine(stack))
