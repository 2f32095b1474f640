"""PyTorch port: the FFT display spectrum (``analysis/fft.py``,
``ops/fft``, ``ops/window.hann_symmetric``, ``ops/resample.
area_downsample``) and Richardson-Lucy deconvolution
(``analysis/deconvolution.py``) against the JAX package's on the CPU,
on seeded numpy inputs of 64² to 130 × 90.

Tolerances, and why:

- the spectrum within 1e-5 of its largest value: the JAX package's
  four-step matmul FFT and pocketfft differ by ~1e-6 relative per
  transform, and log1p keeps it;
- ``area_downsample`` within 1e-6 of its largest value (box sums of up
  to 90 values as products, in another order: 3 ulp measured), the
  empty boxes (no finite value) equal;
- RL held to JAX within 5e-5 of the image's largest value (measured
  1.2e-5 at 20 iterations with dering: the FFT rounding repeated 2 × 20
  times) with ``iterations_run`` equal, and within 1e-5 of a numpy f64
  ``np.fft`` oracle of the port's own loop (the same FFT size);
  ``convergence`` within 1e-3 relative of both;
- the Gaussian PSF, the window and the PSF spectrum's centre-origin
  wraparound exact.
"""

import numpy as np
import pytest
import torch

from astroburst_tpu.analysis import deconvolution as jdec
from astroburst_tpu.analysis import fft as jfft
from astroburst_tpu.dtypes import RLConfig as JRL
from astroburst_tpu.ops import fft as jF
from astroburst_tpu.ops.resample import area_downsample as j_area
from astroburst_tpu.ops.window import hann_symmetric as j_hann
from astroburst_tpu_torch.analysis import deconvolution as tdec
from astroburst_tpu_torch.analysis import fft as tfft
from astroburst_tpu_torch.dtypes import RLConfig as TRL
from astroburst_tpu_torch.ops import fft as tF
from astroburst_tpu_torch.ops.resample import area_downsample as t_area
from astroburst_tpu_torch.ops.window import hann_symmetric as t_hann
from astroburst_tpu_torch.runtime.progress import ProgressHandle

torch.set_num_threads(1)


def _img(shape, seed, nan=True):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 100.0 + 5.0).astype(np.float32)
    if nan:
        img[3, 4] = np.nan
        img[-2, 1] = np.inf
    return img


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 77, 513])
def test_hann_symmetric_equals_jax(n):
    np.testing.assert_array_equal(t_hann(n), j_hann(n))


@pytest.mark.parametrize("n", [1, 5, 64, 100, 127, 2048, 4110, 8191])
def test_next_fast_size_is_the_smallest_smooth_size(n):
    m = tF.next_fast_size(n)
    r = m
    for p in (2, 3, 5, 7):
        while r % p == 0:
            r //= p
    assert m >= n and r == 1
    for k in range(n, m):
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        assert k != 1


def test_fftshift_and_log_magnitude_match_jax():
    rng = np.random.default_rng(3)
    xr = rng.normal(size=(6, 9)).astype(np.float32)
    xi = rng.normal(size=(6, 9)).astype(np.float32)
    np.testing.assert_array_equal(tF.fftshift2(torch.from_numpy(xr)).numpy(),
                                  np.asarray(jF.fftshift2(xr)))
    got = tF.shifted_log_magnitude(torch.from_numpy(xr),
                                   torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jF.shifted_log_magnitude(xr, xi)), rtol=2e-7, atol=0)


@pytest.mark.parametrize("out", [(33, 20), (64, 45), (7, 90), (130, 1)])
def test_area_downsample_matches_jax(out):
    x = _img((130, 90), 4)
    x[10:14, 20:40] = np.nan       # a box with no finite value
    got = t_area(torch.from_numpy(x), *out).numpy()
    want = np.asarray(j_area(x, *out))
    assert got.shape == want.shape == out
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("shape,window", [((100, 77), True),
                                          ((100, 77), False),
                                          ((64, 64), True),
                                          ((128, 96), True)])
def test_power_spectrum_matches_jax(shape, window):
    img = _img(shape, 5)
    got = tfft.compute_power_spectrum(torch.from_numpy(img), window)
    want = jfft.compute_power_spectrum(img, window)
    for k in ("display_width", "display_height", "original_size",
              "windowed"):
        assert getattr(got, k) == getattr(want, k), k
    w = np.asarray(want.spectrum)
    assert np.abs(got.spectrum.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_power_spectrum_downsamples_past_1024(monkeypatch):
    """Past MAX_DISPLAY_SIZE the spectrum is area-downsampled (here at a
    display size of 16 for a 100 × 77 plane, 128² FFT)."""
    monkeypatch.setattr(tfft, "MAX_DISPLAY_SIZE", 16)
    monkeypatch.setattr(jfft, "MAX_DISPLAY_SIZE", 16)
    img = _img((100, 77), 6)
    got = tfft.compute_power_spectrum(torch.from_numpy(img))
    want = jfft.compute_power_spectrum(img)
    assert got.spectrum.shape == (16, 16) and got.original_size == 128
    w = np.asarray(want.spectrum)
    assert np.abs(got.spectrum.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("size,sigma", [(15, 2.0), (7, 1.0), (4, 0.7)])
def test_gaussian_psf_equals_jax(size, sigma):
    np.testing.assert_array_equal(tdec.generate_gaussian_psf(size, sigma),
                                  jdec.generate_gaussian_psf(size, sigma))


def test_psf_spectrum_places_the_centre_at_the_origin():
    psf = np.zeros((5, 7), np.float32)
    psf[2, 3] = 1.0
    spec = tdec.psf_spectrum(psf, 12, 16, torch.device("cpu"))
    assert spec.shape == (12, 9)
    np.testing.assert_allclose(spec.numpy(), np.ones((12, 9)), atol=1e-7)
    back = torch.fft.irfft2(tdec.psf_spectrum(
        jdec.generate_gaussian_psf(5, 1.0), 12, 16, torch.device("cpu")),
        s=(12, 16)).numpy()
    want = np.zeros((12, 16), np.float32)
    want[:5, :5] = jdec.generate_gaussian_psf(5, 1.0)
    want = np.roll(want, (-2, -2), axis=(0, 1))
    np.testing.assert_allclose(back, want, atol=1e-7)


def rl_oracle(image, psf, iterations, lam, dering, thr):
    """The port's loop in numpy f64 (np.fft), at the port's FFT size."""
    img = image.astype(np.float64)
    rows, cols = img.shape
    fr = tF.next_fast_size(rows + psf.shape[0] - 1)
    fc = tF.next_fast_size(cols + psf.shape[1] - 1)
    buf = np.zeros((fr, fc))
    buf[:psf.shape[0], :psf.shape[1]] = psf
    k = np.fft.rfft2(np.roll(buf, (-(psf.shape[0] // 2),
                                   -(psf.shape[1] // 2)), axis=(0, 1)))

    def conv(x, spec):
        pad = np.zeros((fr, fc))
        pad[:rows, :cols] = x
        return np.fft.irfft2(np.fft.rfft2(pad) * spec, s=(fr, fc))[:rows,
                                                                   :cols]

    inv_reg = 1.0 / (1.0 + lam) if lam > 0 else 1.0
    est, run, conv_v = img, 0, np.finfo(np.float32).max
    for it in range(iterations):
        new = np.maximum(est * conv(img / (conv(est, k) + 1e-6),
                                    np.conj(k)) * inv_reg, 0.0)
        if dering:
            new = np.clip(new, np.maximum(img * (1 - thr), 0.0),
                          img * (1 + thr))
        delta = np.sqrt(np.mean((new - est) ** 2))
        est, run, conv_v = new, it + 1, delta
        if it + 1 >= 3 and delta < 1e-6:
            break
    return est, run, conv_v


@pytest.mark.parametrize("iterations", [5, 20])
@pytest.mark.parametrize("dering", [True, False])
@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_richardson_lucy_matches_jax_and_oracle(iterations, dering, lam):
    img = _img((64, 64), 7, nan=False)
    psf = jdec.generate_gaussian_psf(15, 2.0)
    got = tdec.richardson_lucy(torch.from_numpy(img), psf,
                               TRL(iterations=iterations, dering=dering,
                                   regularization=lam))
    want = jdec.richardson_lucy(img, psf, JRL(iterations=iterations,
                                              dering=dering,
                                              regularization=lam))
    g, w = got.image.numpy(), np.asarray(want.image)
    top = np.abs(w).max()
    assert np.abs(g - w).max() <= 5e-5 * top
    assert got.iterations_run == want.iterations_run == iterations
    assert got.convergence == pytest.approx(want.convergence, rel=1e-3)
    o, run, conv_v = rl_oracle(img, psf, iterations, lam, dering, 0.1)
    assert np.abs(g - o).max() <= 1e-5 * top
    assert got.iterations_run == run
    assert got.convergence == pytest.approx(conv_v, rel=1e-3)


@pytest.mark.parametrize("scale,stop", [(0.0, 3), (3e-7, 3), (7e-7, 12),
                                        (1e-5, 20)])
def test_richardson_lucy_stops_where_jax_stops(scale, stop):
    """The early exit: the estimate freezes once the RMS change is below
    1e-6 after at least 3 iterations (at 3, after 12 where the RMS change
    passes 1e-6 by 0.6%, or never);
    ``iterations_run`` equal to JAX's and the oracle's."""
    img = _img((48, 40), 8, nan=False) * np.float32(scale)
    psf = jdec.generate_gaussian_psf(9, 1.5)
    got = tdec.richardson_lucy(torch.from_numpy(img), psf,
                               TRL(iterations=20, dering=False))
    want = jdec.richardson_lucy(img, psf, JRL(iterations=20, dering=False))
    o, run, _ = rl_oracle(img, psf, 20, 0.0, False, 0.1)
    assert got.iterations_run == want.iterations_run == run == stop
    w = np.asarray(want.image)
    top = max(np.abs(w).max(), 1e-30)
    assert np.abs(got.image.numpy() - w).max() <= 5e-5 * top
    assert np.abs(got.image.numpy() - o).max() <= 1e-5 * top


def test_richardson_lucy_progress_and_cancel():
    img = _img((32, 32), 9, nan=False)
    psf = tdec.generate_gaussian_psf(5, 1.0)
    h = ProgressHandle("deconv-progress", total=3)
    res = tdec.richardson_lucy(torch.from_numpy(img), psf,
                               TRL(iterations=3), h)
    assert res.iterations_run == 3
    h.cancel()
    from astroburst_tpu_torch.errors import Cancelled
    with pytest.raises(Cancelled):
        tdec.richardson_lucy(torch.from_numpy(img), psf, TRL(iterations=3),
                             h)


def test_fast_precision_changes_nothing():
    img = _img((40, 40), 10, nan=False)
    psf = tdec.generate_gaussian_psf(7, 1.2)
    a = tdec.richardson_lucy(torch.from_numpy(img), psf, TRL(iterations=4))
    b = tdec.richardson_lucy(torch.from_numpy(img), psf,
                             TRL(iterations=4, fast_precision=True))
    assert torch.equal(a.image, b.image)
