"""Stacking: crop, align, shift + sigma-clip combine
(counterpart of astroburst_tpu/stacking/combine.py).

``sigma_clip_core`` lives in stacking/clip.py and is re-exported here,
where the JAX package defines it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from astroburst_tpu_torch.alignment.phase_correlation import (
    phase_correlate_stack)
from astroburst_tpu_torch.dtypes import StackConfig
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime.device import cuda_device
from astroburst_tpu_torch.stacking.clip import sigma_clip_core
from astroburst_tpu_torch.stacking.onepass_kernel import shift_clip_onepass


@dataclass
class StackResult:
    image: torch.Tensor
    frame_count: int
    rejected_pixels: int
    offsets: List[Tuple[int, int]]
    confidences: List[float]


def stack_images(images: Sequence, config: StackConfig = StackConfig(),
                 progress: Optional[object] = None,
                 device: Optional[torch.device] = None) -> StackResult:
    """Crop to common dims, align to frame 0, shift and sigma-clip
    combine (combine.rs:94-192).

    ``images`` are [H, W] arrays or tensors; they go to ``device``
    (default: the first tensor's device, else ``cuda_device()``).
    ``progress`` is any object with ``tick_with_stage`` and
    ``check_cancelled`` (e.g. runtime/progress.ProgressHandle); it is
    called only when given.
    """
    if len(images) == 0:
        raise InvalidInput("No images to stack")
    if device is None:
        first = images[0]
        device = first.device if isinstance(first, torch.Tensor) else \
            cuda_device()
    min_rows = min(int(img.shape[0]) for img in images)
    min_cols = min(int(img.shape[1]) for img in images)
    stack = torch.stack([
        torch.as_tensor(img)[:min_rows, :min_cols].to(device=device,
                                                      dtype=torch.float32)
        for img in images])
    n = stack.shape[0]

    offsets: List[Tuple[int, int]] = [(0, 0)]
    confidences: List[float] = [0.0]
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    if config.align and n > 1:
        dys1, dxs1, confs = phase_correlate_stack(stack[0], stack[1:])
        dys = torch.cat([zeros[:1], dys1])
        dxs = torch.cat([zeros[:1], dxs1])
        if progress is not None:
            progress.tick_with_stage("align", n - 1)
            progress.check_cancelled()
        host = torch.stack([dys1, dxs1, confs]).cpu().numpy()  # one fetch
        offsets += [(int(round(float(dy))), int(round(float(dx))))
                    for dy, dx in zip(host[0], host[1])]
        confidences += [float(c) for c in host[2]]
    else:
        dys = dxs = zeros
        offsets += [(0, 0)] * (n - 1)
        confidences += [0.0] * (n - 1)

    combined, rejected = shift_clip_onepass(
        stack, dys, dxs, config.sigma_low, config.sigma_high,
        config.max_iterations)
    if progress is not None:
        progress.tick_with_stage("combine")
    return StackResult(image=combined, frame_count=n,
                       rejected_pixels=int(rejected), offsets=offsets,
                       confidences=confidences)


__all__ = ["sigma_clip_core", "stack_images", "StackResult"]
