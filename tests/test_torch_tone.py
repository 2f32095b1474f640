"""PyTorch port: the arcsinh stretch, SCNR, levels, tone curves, the
boundary samplers, the normalization primitives and the confidence
helpers against the JAX package and the reference oracles of
tests/reference_impl/ (``curves.py``, ``scnr.py``).

Inputs are made with numpy from a seed and fed to both packages (the
port on the CPU). Tolerances, and why:

- SCNR: bit-equal to the reference's scalar f32 oracle
  (``ref_apply_scnr``, every operation rounded), since torch contracts
  nothing; JAX within 1e-6, the tolerance it keeps to that oracle
  (tests/test_reference_impl.py:109-119), as XLA on the CPU contracts
  ``g + amount·(gc − g)`` to an FMA (ROADMAP C13; measured 2.98e-7).
- Levels: bit-equal to a numpy f32 oracle rounded at every operation at
  gamma 1; with a gamma, within 2 ulp of 1 (torch's ``pow`` against
  numpy's, ROADMAP C19); JAX within the same; the reference's f64
  oracle within 1e-5, as JAX holds it (JAX measured 5.96e-8 apart).
- Curves: ``lut()`` bit-equal to ``ref_spline_lut`` (both bake in f64
  and round once); JAX's ``lut()`` and ``apply`` within 1e-6, the
  tolerance JAX keeps to that oracle (tests/test_reference_impl.py:
  122-128), since JAX evaluates the spline in f32 (measured 2.98e-7);
  ``apply`` equal to the numpy LUT gather.
- Arcsinh: within 8 ulp of 1.0 (9.5e-7) of JAX — torch's ``asinh`` and
  ``pow`` differ from XLA's by a few ulp (measured up to 5.4e-7, at
  factor 1 and gamma 2.2, where 1/asinh(1) and the pow each round) —
  and within 1e-6 of an f64 oracle.
- Boundary index modes: equal. Nearest and bilinear samples: bit-equal
  to a numpy f32 oracle, JAX within 2 ulp of the plane's largest
  magnitude (FMA); bicubic: JAX within 4 ulp of that magnitude
  (measured: both bit-equal to JAX on this XLA).
- Normalization and confidence: within 2e-6 relative of JAX (torch's
  and XLA's sums run in other orders); the degenerate cases equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.dtypes import ScnrConfig as JScnrConfig
from astroburst_tpu.dtypes import ScnrMethod as JScnrMethod
from astroburst_tpu.ops import boundary as jbd
from astroburst_tpu.ops import normalization as jnorm
from astroburst_tpu.analysis import confidence as jconf
from astroburst_tpu_torch.analysis import confidence as tconf
from astroburst_tpu_torch.dtypes import ScnrConfig, ScnrMethod
from astroburst_tpu_torch.ops import boundary as tbd
from astroburst_tpu_torch.ops import normalization as tnorm
from tests.reference_impl import (ref_apply_levels, ref_apply_scnr,
                                  ref_spline_lut)
from tests.test_reference_impl import FIX

jst = importlib.import_module("astroburst_tpu.imaging.stretch")
tst = importlib.import_module("astroburst_tpu_torch.imaging.stretch")
jscnr = importlib.import_module("astroburst_tpu.imaging.scnr")
tscnr = importlib.import_module("astroburst_tpu_torch.imaging.scnr")
jcur = importlib.import_module("astroburst_tpu.imaging.curves")
tcur = importlib.import_module("astroburst_tpu_torch.imaging.curves")

torch.set_num_threads(1)

CPU = torch.device("cpu")
ULP1 = float(np.spacing(np.float32(1.0)))   # 1.19e-7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _j(a):
    return np.asarray(a)


def _plane(rng, h=64, w=80, lo=0.0, hi=1.0, bad=True):
    x = rng.uniform(lo, hi, (h, w)).astype(np.float32)
    if bad:
        x[1, 2] = np.nan
        x[3, 4] = np.inf
        x[5, 6] = -np.inf
        x[7, 8] = -0.25
        x[9, :5] = 0.0
    return x


# ---- arcsinh stretch --------------------------------------------------------


def _asinh_oracle(x, dmin, dmax, factor, gamma):
    """f64 evaluation of stretch.rs:30-44 on the f32 inputs."""
    x64 = x.astype(np.float64)
    rng = float(np.float32(dmax) - np.float32(dmin))
    if rng < 1e-10:
        return np.zeros_like(x, np.float64)
    norm = np.clip((x64 - dmin) / rng, 0.0, 1.0)
    out = np.arcsinh(norm * factor) / np.arcsinh(factor)
    if abs(gamma - 1.0) > 1e-6:
        out = np.maximum(out, 0.0) ** gamma
    return np.where(np.isfinite(x64), out, 0.0)


@pytest.mark.parametrize("gamma", [1.0, 2.2, 0.5])
@pytest.mark.parametrize("factor", [1.0, 50.0, 500.0])
def test_arcsinh_stretch_matches_jax_and_oracle(rng, factor, gamma):
    x = _plane(rng, lo=0.01, hi=3.0)
    got = tst.arcsinh_stretch(_t(x), factor, gamma).numpy()
    want = _j(jst.arcsinh_stretch(jnp.asarray(x), factor, gamma))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * ULP1)
    valid = np.isfinite(x) & (x > 1e-7)
    dmin, dmax = float(x[valid].min()), float(x[valid].max())
    np.testing.assert_allclose(got, _asinh_oracle(x, dmin, dmax, factor,
                                                  gamma), rtol=0, atol=1e-6)
    assert np.all(got[~np.isfinite(x)] == 0.0)


def test_arcsinh_edge_cases(rng):
    x = _plane(rng)
    t = _t(x)
    # |factor| < 1e-10: the input itself, NaN included
    assert tst.arcsinh_stretch_with_stats(t, 0.0, 1.0, 1e-11) is t
    r, g, b = (_t(x), _t(x), _t(x))
    assert tst.arcsinh_stretch_rgb_with_stats(r, g, b, None, None, 0.0) == \
        (r, g, b)
    # degenerate range: zeros, as JAX
    flat = np.full((8, 9), 0.4, np.float32)
    got = tst.arcsinh_stretch(_t(flat), 30.0).numpy()
    np.testing.assert_array_equal(got, np.zeros_like(flat))
    np.testing.assert_array_equal(
        got, _j(jst.arcsinh_stretch(jnp.asarray(flat), 30.0)))
    # a plane without one valid pixel: the range (0, 0), zeros
    dead = np.full((4, 4), np.nan, np.float32)
    np.testing.assert_array_equal(
        tst.arcsinh_stretch(_t(dead), 30.0).numpy(), np.zeros((4, 4)))
    np.testing.assert_array_equal(
        tst.arcsinh_stretch(_t(dead), 30.0).numpy(),
        _j(jst.arcsinh_stretch(jnp.asarray(dead), 30.0)))


def test_arcsinh_rgb_shares_one_range(rng):
    planes = [_plane(rng, lo=a, hi=b) for a, b in ((0.1, 1.0), (0.0, 2.0),
                                                   (0.3, 0.7))]
    got = tst.arcsinh_stretch_rgb(*(_t(p) for p in planes), 30.0)
    want = jst.arcsinh_stretch_rgb(*(jnp.asarray(p) for p in planes), 30.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _j(w), rtol=0, atol=8 * ULP1)
    got = tst.arcsinh_stretch_rgb_with_stats(*(_t(p) for p in planes), 0.2,
                                             1.5, 10.0, 2.2)
    want = jst.arcsinh_stretch_rgb_with_stats(
        *(jnp.asarray(p) for p in planes), 0.2, 1.5, 10.0, 2.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _j(w), rtol=0, atol=8 * ULP1)


# ---- SCNR -------------------------------------------------------------------


@pytest.mark.parametrize("method", ["average_neutral", "maximum_neutral"])
@pytest.mark.parametrize("amount", [0.3, 1.0, 1.7])
@pytest.mark.parametrize("preserve", [False, True])
def test_scnr_bit_equal_to_oracle_and_close_to_jax(rng, method, amount,
                                                   preserve):
    r, g, b = (rng.uniform(0.0, 1.2, (24, 40)).astype(np.float32)
               for _ in range(3))
    g[::3] += 0.3
    m = ScnrMethod.MAXIMUM_NEUTRAL if method == "maximum_neutral" else \
        ScnrMethod.AVERAGE_NEUTRAL
    got = tscnr.apply_scnr(_t(r), _t(g), _t(b),
                           ScnrConfig(m, amount, preserve))
    want = ref_apply_scnr(r, g, b, method, amount, preserve)
    jm = JScnrMethod(m.value)
    jgot = jscnr.apply_scnr(r, g, b, JScnrConfig(jm, amount, preserve))
    for a, o, j in zip(got, want, jgot):
        np.testing.assert_array_equal(a.numpy(), o)
        np.testing.assert_allclose(a.numpy(), _j(j), rtol=0, atol=1e-6)


def test_scnr_pinned_fixture_and_early_returns():
    got = tscnr.apply_scnr(_t(FIX["scnr_r_in"]), _t(FIX["scnr_g_in"]),
                           _t(FIX["scnr_b_in"]),
                           ScnrConfig(ScnrMethod.AVERAGE_NEUTRAL, 0.8, True))
    for a, name in zip(got, ("scnr_r", "scnr_g", "scnr_b")):
        np.testing.assert_array_equal(a.numpy(), FIX[name])
    r, g, b = _t(np.ones((4, 4))), _t(np.ones((4, 4))), _t(np.ones((4, 5)))
    assert tscnr.apply_scnr(r, g, b) == (r, g, b)       # shapes differ
    b = _t(np.ones((4, 4)))
    for amount in (0.0, 5e-8, -1.0):
        assert tscnr.apply_scnr(r, g, b, ScnrConfig(amount=amount)) == \
            (r, g, b)


def test_scnr_method_parse_matches_jax():
    for s in (None, "", "max", "Maximum", "maximum_neutral", "average",
              "avg", "MAX"):
        assert ScnrMethod.parse(s).value == JScnrMethod.parse(s).value, s


# ---- levels -----------------------------------------------------------------


def _levels_oracle(x, black, white, gamma):
    """numpy f32, every operation rounded (curves.rs:31-52)."""
    inv_range = np.float32(1.0 / max(white - black, 1e-15))
    inv_g = np.float32(1.0 / min(max(gamma, 0.01), 10.0))
    with np.errstate(invalid="ignore"):
        norm = np.clip((x - np.float32(black)) * inv_range, np.float32(0.0),
                       np.float32(1.0))
        out = np.power(norm, inv_g).astype(np.float32)
        return np.where(np.isfinite(x) & (x >= 0.0), out,
                        np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("black,white,gamma", [
    (0.1, 0.8, 1.0), (0.0, 0.5, 1.0), (0.1, 0.8, 1.6), (0.05, 1.0, 0.4),
    (0.2, 0.2, 2.0), (0.0, 1.0, 50.0)])
def test_levels_match_oracles_and_jax(rng, black, white, gamma):
    x = _plane(rng, lo=-0.1, hi=1.2)
    p = tcur.LevelsParams(black=black, gamma=gamma, white=white)
    got = tcur.apply_levels(_t(x), p).numpy()
    want = _j(jcur.apply_levels(jnp.asarray(x), jcur.LevelsParams(
        black=black, gamma=gamma, white=white)))
    oracle = _levels_oracle(x, black, white, gamma)
    if gamma == 1.0:
        np.testing.assert_array_equal(got, oracle)
    else:
        np.testing.assert_allclose(got, oracle, rtol=0, atol=2 * ULP1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ULP1)
    assert np.all(got[~(np.isfinite(x) & (x >= 0.0))] == 0.0)


def test_levels_pinned_fixture_and_identity():
    got = tcur.apply_levels(_t(FIX["stats_input"]), tcur.LevelsParams(
        black=0.1, white=0.8, gamma=1.6)).numpy()
    np.testing.assert_allclose(got, FIX["levels"], atol=1e-5)
    np.testing.assert_allclose(
        got, ref_apply_levels(FIX["stats_input"], 0.1, 0.8, 1.6), atol=1e-5)
    t = _t(FIX["stats_input"])
    assert tcur.apply_levels(t, tcur.LevelsParams()) is t
    for params in (tcur.LevelsParams(), tcur.LevelsParams(black=5e-8),
                   tcur.LevelsParams(black=1e-6),
                   tcur.LevelsParams(gamma=1.0 + 2e-7),
                   tcur.LevelsParams(white=0.9)):
        jp = jcur.LevelsParams(params.black, params.gamma, params.white)
        assert params.is_identity() == jp.is_identity()
    lv = [tcur.LevelsParams(0.1, 1.0, 1.0), tcur.LevelsParams(),
          tcur.LevelsParams(0.0, 2.0, 0.9)]
    out = tcur.apply_levels_rgb(t, t, t, *lv)
    assert out[1] is t
    for o, p in zip(out, lv):
        np.testing.assert_array_equal(o.numpy(),
                                      tcur.apply_levels(t, p).numpy())


# ---- curves -----------------------------------------------------------------


CURVES = [
    [(0.0, 0.0), (0.25, 0.4), (0.7, 0.65), (1.0, 1.0)],   # the fixture's
    [(0.5, 0.6)],                                         # anchored ends
    [(0.2, 0.5), (0.5, 0.2), (0.8, 0.9)],                 # not monotone
    [(0.0, 0.1), (0.3, 0.1), (0.6, 0.1), (1.0, 0.9)],     # flat run
    [(0.1, 0.0), (0.1, 0.5), (0.9, 1.0)],                 # duplicate x
    [(0.0, 1.0), (1.0, 0.0)],                             # inverted
    [(0.3, 0.05), (0.35, 0.95)],                          # steep, clipped
    [],
]


@pytest.mark.parametrize("points", CURVES)
def test_curve_lut_bit_equal_to_reference_and_close_to_jax(points):
    got = tcur.SplineCurve(points).lut()
    assert got.dtype == np.float32 and got.shape == (4096,)
    np.testing.assert_array_equal(got, ref_spline_lut(points))
    jc = jcur.SplineCurve(points)
    np.testing.assert_allclose(got, jc.lut(), rtol=0, atol=1e-6)
    pts = tcur._prepare_points(points)
    np.testing.assert_array_equal(pts, jcur._prepare_points(points))
    np.testing.assert_array_equal(tcur.fritsch_carlson_tangents(pts),
                                  jcur.fritsch_carlson_tangents(pts))


def test_curve_pinned_fixture():
    np.testing.assert_array_equal(tcur.SplineCurve(CURVES[0]).lut(),
                                  FIX["spline_lut"])


@pytest.mark.parametrize("points", CURVES[:4])
def test_curve_apply_is_the_lut_gather(rng, points):
    x = _plane(rng, lo=-0.2, hi=1.3)
    x[10, :6] = [0.0, 1.0, 1.0 / 4095, 4094.5 / 4095, np.nextafter(
        np.float32(1.0), np.float32(0.0)), 1e-9]
    curve = tcur.SplineCurve(points)
    got = curve.apply(_t(x)).numpy()
    lut = curve.lut()
    valid = np.isfinite(x) & (x >= 0.0)
    v = np.where(valid, x, np.float32(0.0))
    idx = np.floor(np.clip(v, 0, 1) * np.float32(4095.0)).astype(np.int64)
    np.testing.assert_array_equal(got, np.where(valid, lut[idx], 0.0))
    want = _j(jcur.SplineCurve(points).apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[~valid] == 0.0)
    np.testing.assert_array_equal(tcur.apply_curve(_t(x), curve).numpy(),
                                  got)
    rgb = tcur.apply_curve_rgb(_t(x), _t(x), _t(x), curve, curve, curve)
    for o in rgb:
        np.testing.assert_array_equal(o.numpy(), got)


@pytest.mark.parametrize("points", [
    [], [(0.3, 0.3)], [(0.3, 0.31)], [(0.0, 0.0), (1.0, 1.0)],
    [(5e-7, 0.0), (1.0, 1.0 - 5e-7)], [(0.0, 0.0), (0.9, 0.9)],
    [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)], [(0.0, 1e-5), (1.0, 1.0)]])
def test_identity_curve_matches_jax(points):
    assert tcur.is_identity_curve(points) == jcur.is_identity_curve(points)


# ---- boundary index modes and samplers --------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("mode", ["clamp", "wrap", "reflect", "other"])
def test_index_modes_match_jax(n, mode):
    idx = np.arange(-23, 24, dtype=np.int32)
    got = tbd.resolve_index(torch.from_numpy(idx), n, mode).numpy()
    want = _j(jbd.resolve_index(jnp.asarray(idx), n, mode))
    np.testing.assert_array_equal(got, want)


def _sample_coords(rng, h, w, k=400):
    ys = rng.uniform(-3.0, h + 2.0, k).astype(np.float32)
    xs = rng.uniform(-3.0, w + 2.0, k).astype(np.float32)
    ys[:4] = [0.5, 1.5, h - 0.5, 2.0]    # round-half-even and exact
    xs[:4] = [2.5, 0.5, w - 1.0, 3.0]
    return ys, xs


def test_nearest_and_bilinear_match_oracle_and_jax(rng):
    h, w = 31, 47
    img = rng.normal(10.0, 3.0, (h, w)).astype(np.float32)
    ys, xs = _sample_coords(rng, h, w)
    top = float(np.abs(img).max())
    iy = np.clip(np.round(ys).astype(np.int64), 0, h - 1)
    ix = np.clip(np.round(xs).astype(np.int64), 0, w - 1)
    got = tbd.nearest_sample(_t(img), _t(ys), _t(xs)).numpy()
    np.testing.assert_array_equal(got, img[iy, ix])
    np.testing.assert_array_equal(got, _j(jbd.nearest_sample(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))))

    y0, x0 = np.floor(ys), np.floor(xs)
    fy, fx = ys - y0, xs - x0
    r0 = np.clip(y0.astype(np.int64), 0, h - 1)
    r1 = np.clip(y0.astype(np.int64) + 1, 0, h - 1)
    c0 = np.clip(x0.astype(np.int64), 0, w - 1)
    c1 = np.clip(x0.astype(np.int64) + 1, 0, w - 1)
    t_ = img[r0, c0] + (img[r0, c1] - img[r0, c0]) * fx
    b_ = img[r1, c0] + (img[r1, c1] - img[r1, c0]) * fx
    got = tbd.bilinear_sample(_t(img), _t(ys), _t(xs)).numpy()
    np.testing.assert_array_equal(got, t_ + (b_ - t_) * fy)
    np.testing.assert_allclose(got, _j(jbd.bilinear_sample(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))),
        rtol=0, atol=2 * top * float(np.spacing(np.float32(1.0))))


def test_bicubic_sample_matches_jax(rng):
    h, w = 29, 41
    img = rng.normal(10.0, 3.0, (h, w)).astype(np.float32)
    ys, xs = _sample_coords(rng, h, w)
    top = float(np.abs(img).max())
    got = tbd.bicubic_sample(_t(img), _t(ys), _t(xs)).numpy()
    want = _j(jbd.bicubic_sample(jnp.asarray(img), jnp.asarray(ys),
                                 jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * top * float(np.spacing(
                                   np.float32(1.0))))
    # at integer coordinates the Catmull-Rom taps are (0, 1, 0, 0)
    iy = rng.integers(0, h, 50).astype(np.float32)
    ix = rng.integers(0, w, 50).astype(np.float32)
    np.testing.assert_array_equal(
        tbd.bicubic_sample(_t(img), _t(iy), _t(ix)).numpy(),
        img[iy.astype(int), ix.astype(int)])


# ---- normalization and confidence -------------------------------------------


@pytest.mark.parametrize("name", ["min_max_normalize", "z_score_normalize",
                                  "unit_energy_normalize"])
@pytest.mark.parametrize("kind", ["normal", "constant", "with_nan", "zeros"])
def test_normalizers_match_jax(rng, name, kind):
    x = rng.normal(5.0, 2.0, (37, 53)).astype(np.float32)
    if kind == "constant":
        x[:] = 3.25
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "with_nan":
        x[4, 5] = np.nan
        x[6, 7] = np.inf
    got = getattr(tnorm, name)(_t(x)).numpy()
    want = _j(getattr(jnorm, name)(jnp.asarray(x)))
    top = max(float(np.nanmax(np.abs(np.where(np.isfinite(want), want,
                                              0.0)))), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * top)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("kind", ["normal", "with_nan", "one", "empty"])
def test_mean_sigma_and_snr_match_jax_and_f64(rng, kind):
    x = rng.normal(5.0, 2.0, 500).astype(np.float32)
    if kind == "with_nan":
        x[::7] = np.nan
    elif kind == "one":
        x = x[:1]
    elif kind == "empty":
        x[:] = np.nan
    m, s = (float(v) for v in tnorm.compute_mean_sigma(_t(x)))
    jm, js = (float(v) for v in jnorm.compute_mean_sigma(jnp.asarray(x)))
    f = x[np.isfinite(x)].astype(np.float64)
    om = f.mean() if f.size else 0.0
    os_ = f.std(ddof=1) if f.size > 1 else 0.0
    assert m == pytest.approx(jm, rel=2e-6, abs=1e-6)
    assert s == pytest.approx(js, rel=2e-6, abs=1e-6)
    assert m == pytest.approx(om, rel=2e-6, abs=1e-6)
    assert s == pytest.approx(os_, rel=2e-6, abs=1e-6)
    for peak, mean, sigma in ((9.0, m, s), (9.0, 1.0, 0.0), (1.0, 2.0, -0.5),
                              (3.0, 1.0, 1e-31)):
        assert float(tnorm.compute_snr(peak, mean, sigma, device=CPU)) == \
            pytest.approx(float(jnorm.compute_snr(peak, mean, sigma)),
                          rel=1e-6)


def test_confidence_matches_jax(rng):
    for peak, sigma in ((12.0, 3.0), (5.0, 0.0), (5.0, 1e-8), (-2.0, 0.5),
                        (4.0, float(np.finfo(np.float32).eps))):
        assert float(tconf.compute_detection_snr(peak, sigma,
                                                 device=CPU)) == \
            pytest.approx(float(jconf.compute_detection_snr(peak, sigma)),
                          rel=1e-6)
    surf = rng.normal(0.0, 1.0, (17, 19)).astype(np.float32)
    for s, peak in ((surf, 4.5), (np.full((5, 5), 2.0, np.float32), 3.0),
                    (np.zeros((0,), np.float32), 1.0)):
        got = float(tconf.compute_surface_confidence(_t(s), peak))
        want = float(jconf.compute_surface_confidence(jnp.asarray(s), peak))
        assert got == pytest.approx(want, rel=2e-6, abs=1e-6)


def test_confidence_and_snr_inputs_go_to_the_card(monkeypatch, rng):
    """Arrays and floats are placed on the card, as ``jnp.asarray`` puts
    them on the default accelerator: with no card they raise, never
    quietly run on the CPU. A tensor argument, or ``device``, decides
    the device instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    surf = rng.normal(0.0, 1.0, (17, 19)).astype(np.float32)
    for call in (lambda: tconf.compute_surface_confidence(surf, 4.5),
                 lambda: tconf.compute_surface_confidence([], 1.0),
                 lambda: tconf.compute_detection_snr(12.0, 3.0),
                 lambda: tnorm.compute_snr(9.0, 1.0, 2.0)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
    got = tconf.compute_surface_confidence(surf, 4.5, device=CPU)
    assert got.device == CPU and float(got) == float(
        tconf.compute_surface_confidence(_t(surf), 4.5))
    assert tconf.compute_detection_snr(_t(np.float32(12.0)), 3.0).device == CPU
    assert tnorm.compute_snr(9.0, 1.0, _t(np.float32(2.0))).device == CPU
