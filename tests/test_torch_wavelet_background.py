"""PyTorch port: the à trous wavelet denoise (``imaging/wavelet.py``) and
the polynomial background extraction (``imaging/background.py``)
against numpy oracles and the JAX package.

Inputs are made with numpy from a seed (planes of 96² to 160², 3–4
wavelet scales, a background grid of 8 on 128², cells of 16) and fed to
both packages (the port on the CPU). Tolerances, and why:

- Medians (the wavelet noise median; the background's global median,
  MAD and model median): bit-equal to an ``np.partition`` oracle at
  sorted index cnt // 2 (the port selects exactly); JAX within
  2·range/8⁶ of it, the resolution of its compare-count
  ``masked_rank_values`` (ROADMAP C21).
- The smooth, the wavelet reconstruction, the background model and the
  correction: bit-equal to numpy f32 oracles rounded at every operation
  and given the port's own median; JAX within 8 ulp of the plane's
  largest magnitude for the smooth and the model (XLA may contract the
  sums to FMAs, ROADMAP C13; measured: the smooth bit-equal, the model
  within 1.5e-8 of its 0.13 magnitude), and for
  the reconstruction within the change the median error makes: with
  the soft threshold every kept detail moves by the threshold's change,
  so the image moves by at most Σᵢ|Δthrᵢ| + 8 ulp; with the hard
  threshold a detail flips between 0 and kept only where |detail| lies
  between the two thresholds (the flip budget: every pixel that differs
  by more than 8 ulp lies in that band at some scale, and they are
  < 1 % of the pixels).
- Cell medians and counts: bit-equal to the oracle and to JAX; the
  invalid fractions bit-equal to the oracle and within one ulp of JAX's
  (XLA divides by the constant cell area as a multiply by its
  reciprocal).
- Background samples: the same count as JAX on these scenes (a cell
  median within the median error of ``lo``/``hi`` could enter or
  leave; none does here), the RMS residual within 1e-6 relative, and
  the corrected plane within the model median's error + 8 ulp.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime.progress import ProgressHandle

jw = importlib.import_module("astroburst_tpu.imaging.wavelet")
tw = importlib.import_module("astroburst_tpu_torch.imaging.wavelet")
jb = importlib.import_module("astroburst_tpu.imaging.background")
tb = importlib.import_module("astroburst_tpu_torch.imaging.background")

torch.set_num_threads(1)

F32 = np.float32
ULP1 = float(np.spacing(F32(1.0)))
RES = 8.0 ** 6            # masked_rank_values: 8 bins x 6 rounds


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _scene(rng, h=128, w=160, bad=True, n_stars=25):
    """Noise on a sloped background with Gaussian stars; NaN/inf/zero
    pixels when ``bad``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 100.0 + 8.0 * yy / h + 5.0 * (xx / w) ** 2 + rng.normal(0, 3.0,
                                                                  (h, w))
    for cy, cx, a in zip(rng.uniform(4, h - 4, n_stars),
                         rng.uniform(4, w - 4, n_stars),
                         rng.uniform(50, 800, n_stars)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.5)
    img = img.astype(np.float32)
    if bad:
        img[5, 7] = np.nan
        img[20, 30] = np.inf
        img[40, 2] = -np.inf
        img[h - 1, :9] = 0.0
    return img


def _select(vals, valid):
    """np.partition oracle: the order statistic at sorted index cnt // 2
    of the valid values, 0 when there are none."""
    v = vals[valid]
    if v.size == 0:
        return F32(0.0)
    return np.partition(v, v.size // 2)[v.size // 2]


# ---- wavelet ----------------------------------------------------------------


def _smooth_oracle(x, step):
    """numpy f32, every product and sum rounded, in JAX's tap order."""
    for axis in (1, 0):
        n = x.shape[axis]
        out = None
        for ki, kv in enumerate(tw.B3_KERNEL):
            idx = np.clip(np.arange(n) + (ki - 2) * step, 0, n - 1)
            term = F32(kv) * np.take(x, idx, axis=axis)
            out = term if out is None else out + term
        x = out
    return x


def _wavelet_oracle(img, num_scales, thresholds, linear, noise):
    """The reconstruction with the given noise sigma (f32), numpy f32."""
    cur, details = img, []
    thr = []
    with np.errstate(invalid="ignore"):
        for s in range(num_scales):
            sm = _smooth_oracle(cur, 1 << s)
            details.append(cur - sm)
            cur = sm
        recon = cur
        for s, d in enumerate(details):
            t = F32(thresholds[s]) * F32(noise) * F32(
                tw.atrous_noise_scaling(s))
            thr.append(t)
            a = np.abs(d)
            if linear:
                d = np.where(a <= t, F32(0.0), np.sign(d) * (a - t))
            else:
                d = np.where(a <= t, F32(0.0), d)
            recon = recon + d
        out = np.where(np.isfinite(recon) & (recon >= 0), recon, F32(0.0))
    return out.astype(F32), details, thr


@pytest.mark.parametrize("step", [1, 2, 4, 8, 64])
def test_atrous_smooth_matches_oracle_and_jax(rng, step):
    x = _scene(rng, 96, 130)
    got = tw.atrous_smooth(_t(x), step).numpy()
    np.testing.assert_array_equal(got, _smooth_oracle(x, step))
    want = np.asarray(jw.atrous_smooth(jnp.asarray(x), step))
    top = float(np.nanmax(np.abs(np.where(np.isfinite(got), got, 0))))
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * ULP1 * top)


@pytest.mark.parametrize("kind", ["scene", "all_nan", "one_finite", "even"])
def test_median_abs_is_the_exact_order_statistic(rng, kind):
    x = rng.normal(0.0, 2.0, (33, 47)).astype(F32)
    x[::5, ::3] = np.nan
    if kind == "all_nan":
        x[:] = np.nan
    elif kind == "one_finite":
        x[:] = np.inf
        x[3, 3] = -1.5
    elif kind == "even":
        x = x[:, :46]
        x[np.isnan(x)] = 0.7
    got = float(tw._median_abs(_t(x)))
    fin = np.isfinite(x)
    assert got == float(_select(np.abs(x), fin))
    want = float(jw._median_abs(jnp.asarray(x)))
    top = float(np.abs(x[fin]).max()) if fin.any() else 0.0
    assert abs(got - want) <= 2.0 * top / RES + 1e-30


@pytest.mark.parametrize("num_scales,linear", [(3, True), (4, True),
                                               (4, False), (3, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_wavelet_denoise_matches_oracle_and_jax(num_scales, linear, seed):
    rng = np.random.default_rng(seed)
    img = _scene(rng, 128, 144)
    thresholds = (3.0, 2.5, 2.0, 1.5, 1.0)
    cfg = tw.WaveletConfig(num_scales, thresholds, linear)
    events = []
    progress = ProgressHandle("wavelet-progress")
    progress.tick_with_stage = lambda s, n=1: events.append(s)
    res = tw.wavelet_denoise(_t(img), cfg, progress)
    assert events == ["wavelet decompose+threshold", "reconstructed"]
    assert res.scales_processed == num_scales
    got = res.denoised.numpy()
    # the port's noise estimate is the exact median of |d0| x 1.4826
    _, details, _ = _wavelet_oracle(img, num_scales, thresholds, linear, 1.0)
    d0 = details[0]
    med = _select(np.abs(d0), np.isfinite(d0))
    noise = F32(med) * F32(1.4826)
    assert res.noise_estimate == float(noise)
    oracle, details, thr_p = _wavelet_oracle(img, num_scales, thresholds,
                                             linear, noise)
    np.testing.assert_array_equal(got, oracle)

    jres = jw.wavelet_denoise(jnp.asarray(img), jw.WaveletConfig(
        num_scales, thresholds, linear))
    want = np.asarray(jres.denoised)
    top_d0 = float(np.abs(d0[np.isfinite(d0)]).max())
    assert abs(res.noise_estimate - jres.noise_estimate) <= \
        2.0 * top_d0 / RES * 1.4826
    _, _, thr_j = _wavelet_oracle(img, num_scales, thresholds, linear,
                                  F32(jres.noise_estimate))
    top = float(np.abs(got).max())
    tol = 8 * ULP1 * top
    diff = np.abs(got - want)
    if linear:
        assert diff.max() <= sum(abs(float(a) - float(b))
                                 for a, b in zip(thr_p, thr_j)) + tol
    else:
        band = np.zeros(img.shape, bool)
        for d, tp, tj in zip(details, thr_p, thr_j):
            a = np.abs(d)
            band |= (a >= min(tp, tj)) & (a <= max(tp, tj))
        flips = diff > tol
        assert not (flips & ~band).any()
        assert flips.mean() < 0.01


def test_wavelet_config_edges(rng):
    img = _scene(rng, 64, 64, bad=False)
    for n, thr, want_n in ((0, (3.0,), 1), (12, (3.0, 2.0), 8),
                           (3, (), 3)):
        res = tw.wavelet_denoise(_t(img), tw.WaveletConfig(n, thr, True))
        jres = jw.wavelet_denoise(jnp.asarray(img),
                                  jw.WaveletConfig(n, thr, True))
        assert res.scales_processed == jres.scales_processed == want_n
        assert res.denoised.shape == img.shape
    for s in range(10):
        assert tw.atrous_noise_scaling(s) == jw.atrous_noise_scaling(s)
    cancelled = ProgressHandle("wavelet-progress")
    cancelled.cancel()
    with pytest.raises(Exception, match="ancel"):
        tw.wavelet_denoise(_t(img), tw.WaveletConfig(), cancelled)


# ---- background -------------------------------------------------------------


def _bg_plane(rng, h=128, w=128, bad=True):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = (0.1 + 0.03 * yy / h + 0.02 * (xx / w) ** 2 - 0.01 * yy * xx
           / (h * w) + rng.normal(0, 0.002, (h, w)))
    for cy, cx in rng.uniform(4, min(h, w) - 4, (12, 2)):
        img += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
    img = img.astype(F32)
    if bad:
        img[:12, :40] = np.nan          # > 30 % invalid in two cells
        img[60, 60] = np.inf
        img[70:72, 10:30] = 0.0
    return img


def _cells_oracle(img, grid):
    rows, cols = img.shape
    ch, cw = rows // grid, cols // grid
    mh, mw = ch // 4, cw // 4
    ih, iw = ch - 2 * mh, cw - 2 * mw
    med, frac, cnt = [], [], []
    for gy in range(grid):
        for gx in range(grid):
            y0, x0 = gy * ch + mh, gx * cw + mw
            v = img[y0:y0 + ih, x0:x0 + iw].ravel()
            v = np.sort(v[np.isfinite(v) & (v > 1e-7)])
            n = v.size
            cnt.append(n)
            frac.append(F32(1.0) - F32(n) / F32(ih * iw))
            med.append((v[max((n - 1) // 2, 0)] + v[n // 2]) * F32(0.5)
                       if n else F32(0.0))
    g = img.ravel()
    gv = np.isfinite(g) & (g > 0.0)
    gmed = _select(g, gv)
    gmad = _select(np.abs(g - gmed), gv)
    return (np.array(med, F32), np.array(frac, F32), np.array(cnt, F32),
            F32(gmed), F32(gmad))


@pytest.mark.parametrize("grid", [3, 8, 32])
def test_cell_medians_match_oracle_and_jax(rng, grid):
    img = _bg_plane(rng)
    rows, cols = img.shape
    ch, cw = rows // grid, cols // grid
    got = tb._cell_medians(_t(img), grid, ch, cw).numpy()
    nc = grid * grid
    med, frac, cnt, gmed, gmad = _cells_oracle(img, grid)
    np.testing.assert_array_equal(got[:nc], med)
    np.testing.assert_array_equal(got[nc:2 * nc], frac)
    np.testing.assert_array_equal(got[2 * nc:3 * nc], cnt)
    assert got[3 * nc] == gmed and got[3 * nc + 1] == gmad
    want = np.asarray(jb._cell_medians_kernel(jnp.asarray(img), grid, ch,
                                              cw))
    np.testing.assert_array_equal(got[:nc], want[:nc])
    np.testing.assert_array_equal(got[2 * nc:3 * nc], want[2 * nc:3 * nc])
    # XLA divides by the constant cell area as a multiply by its
    # reciprocal: the invalid fractions within one ulp of 1
    np.testing.assert_allclose(got[nc:2 * nc], want[nc:2 * nc], rtol=0,
                               atol=ULP1)
    fin = img[np.isfinite(img) & (img > 0)]
    span = float(fin.max() - fin.min())
    assert abs(got[3 * nc] - want[3 * nc]) <= 2.0 * span / RES
    assert abs(got[3 * nc + 1] - want[3 * nc + 1]) <= 2.0 * span / RES \
        + 2.0 * span / RES


@pytest.mark.parametrize("y", range(6))
def test_integer_pow_is_square_and_multiply(y):
    x = np.linspace(-0.5, 0.49, 300).astype(F32)
    got = tb._integer_pow(_t(x), y).numpy()
    want = np.asarray(jnp.asarray(x) ** y)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_model_matches_oracle_and_jax(rng, degree):
    rows, cols = 96, 112
    n_terms = (degree + 1) * (degree + 2) // 2
    coeffs = rng.normal(0.0, 1.0, n_terms)
    got = tb._evaluate_model(coeffs, rows, cols, degree,
                             torch.device("cpu")).numpy()
    c = coeffs.astype(F32)
    ny = (np.arange(rows, dtype=F32) / F32(rows) - F32(0.5))[:, None]
    nx = (np.arange(cols, dtype=F32) / F32(cols) - F32(0.5))[None, :]
    out = np.zeros((rows, cols), F32)
    idx = 0
    for total in range(degree + 1):
        for yp in range(total, -1, -1):
            out = out + c[idx] * np.asarray(jnp.asarray(ny) ** yp) * \
                np.asarray(jnp.asarray(nx) ** (total - yp))
            idx += 1
    np.testing.assert_array_equal(got, out)
    want = np.asarray(jb._evaluate_model(coeffs, rows, cols, degree))
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * top)
    x = rng.normal(0, 0.3, 20)
    y = rng.normal(0, 0.3, 20)
    np.testing.assert_array_equal(tb._poly_basis(y, x, degree),
                                  jb._poly_basis(y, x, degree))
    assert tb.min_samples_for_degree(degree) == \
        jb.min_samples_for_degree(degree)


@pytest.mark.parametrize("mode", ["subtract", "divide"])
@pytest.mark.parametrize("grid,degree,iterations", [(8, 3, 3), (6, 2, 1),
                                                    (10, 4, 5), (8, 1, 2)])
def test_extract_background_matches_oracle_and_jax(rng, mode, grid, degree,
                                                   iterations):
    img = _bg_plane(rng)
    cfg = tb.BackgroundConfig(grid, degree, 2.5, iterations, mode)
    events = []
    progress = ProgressHandle("background-progress", total=4)
    progress.tick_with_stage = lambda s, n=1: events.append(s)
    res = tb.extract_background(_t(img), cfg, progress)
    assert events == ["sampling background", "fitting polynomial surface",
                      "generating model", "applying correction"]
    jres = jb.extract_background(jnp.asarray(img), jb.BackgroundConfig(
        grid, degree, 2.5, iterations, mode))
    assert res.sample_count == jres.sample_count
    assert res.rms_residual == pytest.approx(jres.rms_residual, rel=1e-6,
                                             abs=1e-12)
    model = res.model.numpy()
    jmodel = np.asarray(jres.model)
    mtop = float(np.abs(jmodel).max())
    np.testing.assert_allclose(model, jmodel, rtol=0, atol=1e-6 * mtop)
    # the correction with the port's model and the exact model median
    mv = np.isfinite(model) & (model > 0)
    mmed = _select(model, mv)
    if mode == "divide":
        safe = np.abs(model) > 1e-10
        with np.errstate(invalid="ignore", divide="ignore"):
            oracle = np.where(safe, img / np.where(safe, model, F32(1.0))
                              * mmed, img)
    else:
        oracle = img - model + mmed
    got = res.corrected.numpy()
    np.testing.assert_array_equal(got, oracle.astype(F32))
    jmv = jmodel[np.isfinite(jmodel) & (jmodel > 0)]
    med_err = 2.0 * float(jmv.max() - jmv.min()) / RES
    want = np.asarray(jres.corrected)
    fin = np.isfinite(got)
    np.testing.assert_array_equal(fin, np.isfinite(want))
    top = float(np.abs(got[fin]).max())
    scale = float(np.abs(img[fin] / mmed).max()) if mode == "divide" else 1.0
    assert np.abs(got[fin] - want[fin]).max() <= \
        scale * (med_err + 1e-6 * mtop) + 8 * ULP1 * top


def test_extract_background_refuses_small_and_sparse(rng):
    with pytest.raises(InvalidInput, match="too small"):
        tb.extract_background(_t(np.ones((20, 40), F32)),
                              tb.BackgroundConfig(grid_size=8))
    with pytest.raises(InvalidInput, match="Not enough background"):
        tb.extract_background(_t(np.full((64, 64), np.nan, F32)),
                              tb.BackgroundConfig(grid_size=3,
                                                  poly_degree=5))
    # a grid past 32 is clamped, as in JAX
    img = _bg_plane(rng, bad=False)
    a = tb.extract_background(_t(img), tb.BackgroundConfig(grid_size=99,
                                                           poly_degree=1))
    b = jb.extract_background(jnp.asarray(img), jb.BackgroundConfig(
        grid_size=99, poly_degree=1))
    assert a.sample_count == b.sample_count
