"""FFT helpers (counterpart of astroburst_tpu/ops/fft.py).

The transforms themselves are ``torch.fft.rfft2``/``irfft2`` (cuFFT on
the card): the JAX package's matmul four-step FFT existed only because
the TPU has no ``jnp.fft``, and is not ported. Same contract:
unnormalised forward, 1/n-scaled inverse, power-of-two sizes by zero
padding (fft.rs:64). ``next_fast_size`` is the port's own: the
smallest 2·3·5·7-smooth size, which cuFFT transforms without a
Bluestein pass (the JAX package's sizes suit its four-step engine).
"""

from __future__ import annotations

import torch


def next_power_of_two(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def next_fast_size(n: int) -> int:
    """Smallest m >= n whose only prime factors are 2, 3, 5 and 7."""
    m = max(int(n), 1)
    while True:
        r = m
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def cross_power(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                bi: torch.Tensor, epsilon: float = 1e-15):
    """Normalised cross-power a·conj(b)/|a·conj(b)|, ε-guarded, on
    (real, imag) float32 pairs (complex.rs:27-44)."""
    pr = ar * br + ai * bi
    pi = ai * br - ar * bi
    mag = torch.sqrt(pr * pr + pi * pi)
    inv = 1.0 / torch.clamp(mag, min=epsilon)
    return pr * inv, pi * inv


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """Centre the zero frequency (fft.rs:251-269 shift semantics)."""
    r, c = x.shape[-2], x.shape[-1]
    return torch.roll(x, (r // 2, c // 2), dims=(-2, -1))


def shifted_log_magnitude(xr: torch.Tensor, xi: torch.Tensor
                          ) -> torch.Tensor:
    """log1p(|X|) = log1p(sqrt(re² + im²)), the spectrum centred
    (fft.rs:251)."""
    return fftshift2(torch.log1p(torch.sqrt(xr * xr + xi * xi)))
