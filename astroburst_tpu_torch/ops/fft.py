"""FFT helpers (counterpart of astroburst_tpu/ops/fft.py).

The transforms themselves are ``torch.fft.rfft2``/``irfft2`` (cuFFT on
the card): the JAX package's matmul four-step FFT existed only because
the TPU has no ``jnp.fft``, and is not ported. Same contract:
unnormalised forward, 1/n-scaled inverse, power-of-two sizes by zero
padding (fft.rs:64).
"""

from __future__ import annotations

import torch


def next_power_of_two(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def cross_power(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                bi: torch.Tensor, epsilon: float = 1e-15):
    """Normalised cross-power a·conj(b)/|a·conj(b)|, ε-guarded, on
    (real, imag) float32 pairs (complex.rs:27-44)."""
    pr = ar * br + ai * bi
    pi = ai * br - ar * bi
    mag = torch.sqrt(pr * pr + pi * pi)
    inv = 1.0 / torch.clamp(mag, min=epsilon)
    return pr * inv, pi * inv
