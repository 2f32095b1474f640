"""Richardson-Lucy deconvolution (counterpart of
astroburst_tpu/analysis/deconvolution.py).

Reference: src-tauri/src/core/analysis/deconvolution.rs — the PSF
spectrum precomputed once with centre-origin wraparound
(deconvolution.rs:44-80); iterate convolve → ratio (ε 1e-6) →
correlate with the conjugate spectrum → multiply, with Tikhonov
1/(1+λ) damping and a clamp at 0; the bidirectional deringing clamp;
the early exit once the RMS change is below 1e-6 after at least 3
iterations.

As in the JAX package the exit is a ``stopped`` flag on the device
over a fixed iteration count: the estimate freezes once converged, so
the result is the same, and the loop never waits on the host.
``iterations_run`` and ``convergence`` reach the host once, at the end.

The transforms are ``torch.fft.rfft2`` / ``irfft2`` (cuFFT on the
card). Linear convolution needs an FFT size m >= rows + taps − 1; the
port pads to the smallest 2·3·5·7-smooth such size (``next_fast_size``),
which cuFFT handles without a Bluestein pass, where the JAX package
pads to the sizes its four-step matmul engine handles. The convolution
is the same; only the rounding differs. ``fast_precision`` is the JAX
package's TPU extension (bf16 passes of its matmul FFT): the port
accepts it and runs true f32 either way, since TF32 is off and cuFFT
has no lower-precision f32 path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from astroburst_tpu_torch.dtypes import RLConfig
from astroburst_tpu_torch.ops.fft import next_fast_size
from astroburst_tpu_torch.runtime.device import as_f32
from astroburst_tpu_torch.runtime.progress import ProgressHandle

CONVERGENCE_THRESHOLD = 1e-6
EPSILON = 1e-6


def generate_gaussian_psf(size: int, sigma: float) -> np.ndarray:
    """Normalized Gaussian kernel, built on the host in f64
    (deconvolution.rs:12-33)."""
    center = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    val = np.exp(-(((x - center) ** 2 + (y - center) ** 2) /
                   (2.0 * sigma * sigma)))
    s = val.sum()
    if s > 0:
        val /= s
    return val.astype(np.float32)


def psf_spectrum(psf: np.ndarray, fft_rows: int, fft_cols: int,
                 device: torch.device) -> torch.Tensor:
    """The PSF at the origin with centre-origin wraparound
    (``roll(-cy, -cx)``), as its rfft2 half spectrum
    [fft_rows, fft_cols // 2 + 1] (deconvolution.rs:62-80). Only the
    small PSF crosses to the device."""
    k = torch.as_tensor(np.asarray(psf, np.float32)).to(device)
    pr, pc = k.shape
    buf = torch.zeros((fft_rows, fft_cols), dtype=torch.float32,
                      device=device)
    buf[:pr, :pc] = k
    buf = torch.roll(buf, (-(pr // 2), -(pc // 2)), dims=(0, 1))
    return torch.fft.rfft2(buf)


@dataclass
class RLResult:
    image: torch.Tensor
    iterations_run: int
    convergence: float


def _convolve(x: torch.Tensor, spec: torch.Tensor, fft_rows: int,
              fft_cols: int) -> torch.Tensor:
    rows, cols = x.shape
    buf = torch.nn.functional.pad(x, (0, fft_cols - cols, 0,
                                      fft_rows - rows))
    out = torch.fft.irfft2(torch.fft.rfft2(buf) * spec,
                           s=(fft_rows, fft_cols))
    return out[:rows, :cols]


def rl_loop(image: torch.Tensor, spec: torch.Tensor, fft_rows: int,
            fft_cols: int, iterations: int, regularization: float,
            dering: bool, dering_threshold: float):
    """The RL iterations on the device: (estimate, iterations_run,
    convergence), the last two as 0-d tensors."""
    conj = torch.conj(spec)
    f32 = np.float32
    lam = f32(regularization)
    inv_reg = float(f32(1.0) / (f32(1.0) + lam)) if lam > 0 else 1.0
    thr = f32(dering_threshold)
    upper = image * float(f32(1.0) + thr)
    lower = torch.clamp(image * float(f32(1.0) - thr), min=0.0)
    dev = image.device
    estimate = image
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    iterations_run = torch.zeros((), dtype=torch.int32, device=dev)
    convergence = torch.full((), float(np.finfo(np.float32).max),
                             dtype=torch.float32, device=dev)
    for it in range(iterations):
        convolved = _convolve(estimate, spec, fft_rows, fft_cols)
        ratio = image / (convolved + EPSILON)
        correction = _convolve(ratio, conj, fft_rows, fft_cols)
        new_est = torch.clamp(estimate * correction * inv_reg, min=0.0)
        if dering:
            new_est = torch.minimum(torch.maximum(new_est, lower), upper)
        delta = torch.sqrt(torch.mean((new_est - estimate) ** 2))
        active = ~stopped
        estimate = torch.where(active, new_est, estimate)
        iterations_run = torch.where(active, it + 1, iterations_run)
        convergence = torch.where(active, delta, convergence)
        if it + 1 >= 3:
            stopped = stopped | (active & (delta < CONVERGENCE_THRESHOLD))
    return estimate, iterations_run, convergence


def richardson_lucy(image, psf, config: RLConfig = RLConfig(),
                    progress: Optional[ProgressHandle] = None) -> RLResult:
    """RL deconvolution of ``image`` on its device (a tensor's own,
    else ``cuda_device()``)."""
    img = as_f32(image)
    psf_np = np.asarray(psf, np.float32)
    rows, cols = img.shape
    fft_rows = next_fast_size(rows + psf_np.shape[0] - 1)
    fft_cols = next_fast_size(cols + psf_np.shape[1] - 1)
    spec = psf_spectrum(psf_np, fft_rows, fft_cols, img.device)
    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("deconvolving")
    est, iters, conv = rl_loop(img, spec, fft_rows, fft_cols,
                               config.iterations, config.regularization,
                               config.dering, config.dering_threshold)
    iters, conv = torch.stack([iters.to(torch.float64),
                               conv.to(torch.float64)]).tolist()
    if progress is not None:
        progress.tick_with_stage(f"done ({int(iters)} iterations)")
    return RLResult(image=est, iterations_run=int(iters),
                    convergence=float(conv))
