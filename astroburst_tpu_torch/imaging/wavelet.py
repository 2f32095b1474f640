"""À trous B3-spline wavelet denoising (counterpart of
astroburst_tpu/imaging/wavelet.py).

Reference: src-tauri/src/core/imaging/wavelet.rs — up to 8 scales with
2^k hole spacing, clamped-boundary separable 5-tap smooth, noise σ
from the finest scale (median |detail| · 1.4826), per-scale soft/hard
thresholds with the standard à trous noise-scaling table, reconstruct
with negative/non-finite clamp to 0.

Plain torch on the plane's device (the JAX package computes it outside
any Pallas kernel). The smooth is five clamped ``index_select``s per
axis, summed in the JAX function's order (wavelet.py:52-60); torch
rounds each product and sum, where XLA on the CPU contracts
``out + kv · take`` to an FMA (ROADMAP C13). The noise median is the
exact order statistic of the reference's select_nth(len/2), at sorted
index cnt // 2, read from ``torch.sort`` at a device-side index, where
JAX's compare-count ``masked_rank_values`` lies within range/8⁶ of it
(ROADMAP C21). (``torch.kthvalue`` would select the same value, but
its CUDA form runs one thread block per row, slow on one row of a
whole plane.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.ops.stats import select_half
from astroburst_tpu_torch.runtime.device import as_f32
from astroburst_tpu_torch.runtime.progress import ProgressHandle

B3_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_NOISE_TABLE = (0.8908, 0.2007, 0.0856, 0.0413, 0.0205, 0.0103, 0.0051)


def atrous_noise_scaling(scale: int) -> float:
    if scale < len(_NOISE_TABLE):
        return _NOISE_TABLE[scale]
    return _NOISE_TABLE[6] / (2.0 ** (scale - 6))


@dataclass
class WaveletConfig:
    num_scales: int = 5
    thresholds: Sequence[float] = (3.0, 2.5, 2.0, 1.5, 1.0)
    linear_denoise: bool = True  # True → soft threshold


@dataclass
class WaveletResult:
    denoised: torch.Tensor
    scales_processed: int
    noise_estimate: float


def _smooth_axis(x: torch.Tensor, step: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    base = torch.arange(n, device=x.device)
    out = None
    for ki, kv in enumerate(B3_KERNEL):
        idx = torch.clamp(base + (ki - 2) * step, 0, n - 1)
        term = kv * torch.index_select(x, axis, idx)
        out = term if out is None else out + term
    return out


def atrous_smooth(x: torch.Tensor, step: int) -> torch.Tensor:
    """Separable clamped-boundary B3 smooth at hole spacing ``step``
    (wavelet.rs:135-186): along the rows first, then the columns."""
    return _smooth_axis(_smooth_axis(x, step, 1), step, 0)


def _median_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| at sorted index cnt // 2 over the finite values (the 1-based
    rank floor(cnt/2) + 1 of wavelet.py:71-73); 0 when none is finite."""
    finite = torch.isfinite(x)
    return select_half(torch.where(finite, torch.abs(x), float("inf"))
                       .reshape(-1), finite.sum())


def _denoise(image: torch.Tensor, thresholds: torch.Tensor,
             num_scales: int, linear: bool):
    current = image
    details = []
    for scale_idx in range(num_scales):
        smooth = atrous_smooth(current, 1 << scale_idx)
        details.append(current - smooth)
        current = smooth

    noise_sigma = _median_abs(details[0]) * MAD_TO_SIGMA

    recon = current
    for scale_idx, detail in enumerate(details):
        threshold = (thresholds[scale_idx] * noise_sigma
                     * atrous_noise_scaling(scale_idx))
        a = torch.abs(detail)
        if linear:
            detail = torch.where(a <= threshold, 0.0,
                                 torch.sign(detail) * (a - threshold))
        else:
            detail = torch.where(a <= threshold, 0.0, detail)
        recon = recon + detail

    recon = torch.where(torch.isfinite(recon) & (recon >= 0.0), recon, 0.0)
    return recon, noise_sigma


def wavelet_denoise(image, config: WaveletConfig = WaveletConfig(),
                    progress: Optional[ProgressHandle] = None
                    ) -> WaveletResult:
    """Decompose, threshold and reconstruct ``image`` on its device (a
    tensor's own, else ``cuda_device()``); one host fetch, the noise
    estimate."""
    image = as_f32(image)
    num_scales = min(max(config.num_scales, 1), 8)
    thr = list(config.thresholds) or [1.0]
    while len(thr) < num_scales:
        thr.append(thr[-1])
    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("wavelet decompose+threshold")
    thresholds = torch.tensor(thr[:num_scales],
                              dtype=torch.float32).to(image.device)
    out, noise = _denoise(image, thresholds, num_scales,
                          config.linear_denoise)
    if progress is not None:
        progress.tick_with_stage("reconstructed")
    return WaveletResult(denoised=out, scales_processed=num_scales,
                         noise_estimate=float(noise))
