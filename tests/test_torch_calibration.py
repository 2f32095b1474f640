"""PyTorch port: calibration masters and light calibration against the
JAX package (astroburst_tpu/stacking/calibration.py).

Same f32 operations in the same order, so rtol 1e-6 (the flat's mean
is a sum over the plane, taken in another order); medians are exact
order statistics in both packages, so they are compared at rtol 1e-6
too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.stacking import calibration as jcal
from astroburst_tpu_torch.stacking import calibration as tcal

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0.0)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_median_combine_matches_jax(rng, n):
    s = rng.normal(500, 20, (n, 33, 47)).astype(np.float32)
    s[rng.random(s.shape) < 0.1] = np.nan
    s[:, 0, 0] = np.nan                  # no finite value: 0
    s[:, 0, 1] = np.inf
    s[: max(1, n // 2), 1, 1] = -np.inf
    got = tcal.median_combine(_t(s))
    _close(got, jcal.median_combine(jnp.asarray(s)))
    assert float(got[0, 0]) == 0.0


def _masters(rng, h=40, w=52):
    bias = rng.normal(100, 2, (h, w)).astype(np.float32)
    dark = rng.normal(10, 1, (h, w)).astype(np.float32)
    flat = rng.uniform(0.6, 1.2, (h, w)).astype(np.float32)
    flat[3, 4] = 0.0          # guarded: |flat| <= 1e-4
    flat[5, 6] = 5e-5
    flat[7, 8] = -2e-5
    flat[9, 10] = np.nan      # guarded: non-finite
    return bias, dark, flat


@pytest.mark.parametrize("which", ["all", "bias", "dark", "flat", "none"])
def test_calibrate_image_matches_jax(rng, which):
    bias, dark, flat = _masters(rng)
    raw = rng.normal(130, 15, bias.shape).astype(np.float32)
    raw[0, :10] = 50.0        # below bias + dark: clamped to 0
    raw[1, 1] = np.nan
    use = {"all": (1, 1, 1), "bias": (1, 0, 0), "dark": (0, 1, 0),
           "flat": (0, 0, 1), "none": (0, 0, 0)}[which]
    kw = dict(zip(("master_bias", "master_dark", "master_flat"),
                  (bias, dark, flat)))
    jcfg = jcal.CalibrationConfig(
        **{k: (jnp.asarray(v) if u else None)
           for (k, v), u in zip(kw.items(), use)},
        dark_exposure_ratio=1.5)
    tcfg = tcal.CalibrationConfig(
        **{k: (_t(v) if u else None) for (k, v), u in zip(kw.items(), use)},
        dark_exposure_ratio=1.5)
    got = tcal.calibrate_image(_t(raw), tcfg)
    want = jcal.calibrate_image(jnp.asarray(raw), jcfg)
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(np.asarray(want)))
    _close(got, want)
    assert float(np.nanmin(got.numpy())) >= 0.0
    if which in ("all", "bias"):
        assert (got.numpy()[0, :10] == 0.0).all()


def test_calibration_steps_match_jax(rng):
    bias, dark, flat = _masters(rng)
    img = rng.normal(130, 15, bias.shape).astype(np.float32)
    _close(tcal.subtract_bias(_t(img), _t(bias)),
           jcal.subtract_bias(img, bias))
    _close(tcal.subtract_dark(_t(img), _t(dark), 0.75),
           jcal.subtract_dark(img, dark, 0.75))
    got = tcal.divide_flat(_t(img), _t(flat))
    _close(got, jcal.divide_flat(img, flat))
    for y, x in ((3, 4), (5, 6), (7, 8), (9, 10)):   # guarded: unchanged
        assert float(got[y, x]) == img[y, x]


@pytest.mark.parametrize("case", ["normal", "invalid", "empty"])
def test_mean_normalize_matches_jax(rng, case):
    flat = rng.uniform(5000, 20000, (36, 44)).astype(np.float32)
    if case == "invalid":
        flat[0, :7] = [0.0, -3.0, np.nan, np.inf, -np.inf, 1e-30, -0.0]
    elif case == "empty":    # no finite-positive value: left as is
        flat = -np.abs(flat)
    got = tcal._mean_normalize(_t(flat))
    want = jcal._mean_normalize(jnp.asarray(flat))
    _close(got, want)
    if case == "invalid":
        assert (got.numpy()[0, :5] == 1.0).all()
    if case == "normal":
        assert abs(float(got.mean()) - 1.0) < 1e-5


def test_masters_chain_matches_jax(rng):
    """The array forms of create_master_{bias,dark,flat}: median of the
    stack after subtracting the masters given, then the flat's mean
    normalisation."""
    biases = rng.normal(100, 3, (5, 24, 30)).astype(np.float32)
    darks = biases + rng.normal(12, 2, (5, 24, 30)).astype(np.float32)
    flats = darks + rng.uniform(8000, 12000, (5, 24, 30)).astype(np.float32)
    tb = tcal.median_combine(_t(biases))
    td = tcal.median_combine(_t(darks) - tb[None])
    tf = tcal._mean_normalize(tcal.median_combine(_t(flats) - tb[None]
                                                  - td[None]))
    jb = jcal.median_combine(jnp.asarray(biases))
    jd = jcal.median_combine(jnp.asarray(darks) - jb[None])
    jf = jcal._mean_normalize(jcal.median_combine(
        jnp.asarray(flats) - jb[None] - jd[None]))
    _close(tb, jb)
    _close(td, jd)
    _close(tf, jf)
