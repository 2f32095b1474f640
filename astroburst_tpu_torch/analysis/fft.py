"""FFT power spectrum for display (counterpart of
astroburst_tpu/analysis/fft.py).

Reference: src-tauri/src/core/analysis/fft.rs — optional symmetric
Hann window, square power-of-two FFT, shifted log1p magnitude,
area-average downsample to ≤ 1024. The transform is
``torch.fft.fft2`` (cuFFT on the card), where the JAX package runs its
matmul four-step FFT; the two differ by about 1e-6 relative per
transform.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from astroburst_tpu_torch.ops.fft import (next_power_of_two,
                                          shifted_log_magnitude)
from astroburst_tpu_torch.ops.resample import area_downsample
from astroburst_tpu_torch.ops.window import hann_symmetric
from astroburst_tpu_torch.runtime.device import as_f32

MAX_DISPLAY_SIZE = 1024


@dataclass
class FftResult:
    spectrum: torch.Tensor     # f32 [display_height, display_width]
    display_width: int
    display_height: int
    original_size: int
    windowed: bool


def _spectrum(data: torch.Tensor, size: int,
              apply_window: bool) -> torch.Tensor:
    rows, cols = data.shape
    vals = torch.where(torch.isfinite(data), data, 0.0)
    if apply_window:
        wy = torch.from_numpy(hann_symmetric(rows)).to(data.device)
        wx = torch.from_numpy(hann_symmetric(cols)).to(data.device)
        vals = vals * wy[:, None] * wx[None, :]
    buf = torch.nn.functional.pad(vals, (0, size - cols, 0, size - rows))
    spec = torch.fft.fft2(buf)
    return shifted_log_magnitude(spec.real, spec.imag)


def compute_power_spectrum(data, apply_window: bool = True) -> FftResult:
    """The display spectrum of ``data`` on its device (a tensor's own,
    else ``cuda_device()``)."""
    data = as_f32(data)
    rows, cols = data.shape
    size = next_power_of_two(max(rows, cols))
    spectrum = _spectrum(data, size, apply_window)
    if size > MAX_DISPLAY_SIZE:
        spectrum = area_downsample(spectrum, MAX_DISPLAY_SIZE,
                                   MAX_DISPLAY_SIZE)
    dh, dw = spectrum.shape
    return FftResult(spectrum=spectrum, display_width=dw, display_height=dh,
                     original_size=size, windowed=apply_window)
