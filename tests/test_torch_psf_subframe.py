"""PyTorch port: the empirical PSF (``imaging/psf_estimation.py``) and the
subframe metrics (``analysis/subframe.py``) against the JAX package.

Scenes are made with numpy from a seed: 10–40 Gaussian stars at least
24 px apart on a noisy background, 160² to 192² (the port on the CPU,
JAX's detection on its XLA route). Tolerances, and why:

- detection feeds both: the port's star positions, fluxes, FWHM and SNR
  lie within rel 1e-4 of JAX's and eccentricities within abs 0.01 (the
  moment sums run in another order; tests/test_torch_star_detection.py),
  so scores differ at f32 rounding. On well-separated stars of distinct
  quality the ranking does not reorder: the selected set is equal (the
  same stars in the same order, positions within 1e-3 px), the rejected
  count equal;
- the PSF kernel within 1e-5 absolute and the spread within 1e-5
  relative: the cutouts, recentring and averages are f32 sums in
  another order; ``_cutout_average`` on the same positions within 1e-6;
- the average FWHM and ellipticity within 1e-4 relative / 0.01
  absolute, as the detections they average;
- subframe metrics: the star count equal, the medians within 1e-4
  relative (eccentricity 0.01 absolute), the weights within 1e-4, the
  accept decisions equal; ``_median_of`` and ``compute_weight`` equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu_torch.errors import InvalidInput

jpsf = importlib.import_module("astroburst_tpu.imaging.psf_estimation")
tpsf = importlib.import_module("astroburst_tpu_torch.imaging.psf_estimation")
jsub = importlib.import_module("astroburst_tpu.analysis.subframe")
tsub = importlib.import_module("astroburst_tpu_torch.analysis.subframe")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def star_field(seed, n=20, hw=192, sep=24.0, margin=12, sigma=(1.3, 2.2),
               amp=(0.15, 0.8), bg=0.1, noise=0.004, ellip=0.0):
    """Gaussian stars (per-star sigma; x widened by ``ellip``) at least
    ``sep`` px apart, peaks ``amp`` on ``bg`` + N(0, noise)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(100 * n):
        if len(pts) == n:
            break
        p = rng.uniform(margin, hw - margin, 2)
        if all((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 > sep * sep
               for q in pts):
            pts.append(p)
    assert len(pts) == n, f"{n} stars {sep} px apart do not fit in {hw}^2"
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    img = rng.normal(bg, noise, (hw, hw))
    for (cy, cx), a, s in zip(pts, rng.uniform(*amp, n),
                              rng.uniform(*sigma, n)):
        sx = s * (1.0 + ellip)
        img += a * np.exp(-(yy - cy) ** 2 / (2 * s * s)
                          - (xx - cx) ** 2 / (2 * sx * sx))
    return img.astype(np.float32)


def _same_candidates(got, want, pos_tol=1e-3):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a.x - b.x) <= pos_tol and abs(a.y - b.y) <= pos_tol
        for k in ("peak", "flux", "fwhm", "snr", "distance_from_center"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-4)
        assert abs(a.ellipticity - b.ellipticity) <= 0.01


@pytest.mark.parametrize("seed,n,radius,num", [(0, 20, 15, 30), (1, 30, 8, 5),
                                               (2, 12, 10, 30),
                                               (3, 25, 15, 10)])
def test_estimate_psf_matches_jax(seed, n, radius, num):
    img = star_field(seed, n)
    cfg = dict(num_stars=num, cutout_radius=radius, edge_margin=radius + 2)
    got = tpsf.estimate_psf(_t(img), tpsf.PsfEstimationConfig(**cfg))
    want = jpsf.estimate_psf(jnp.asarray(img),
                             jpsf.PsfEstimationConfig(**cfg))
    assert len(got.stars_used) >= 3
    _same_candidates(got.stars_used, want.stars_used)
    assert got.stars_rejected == want.stars_rejected
    assert got.kernel_size == want.kernel_size == 2 * radius + 1
    assert got.kernel.dtype == np.float32
    assert got.kernel.shape == (2 * radius + 1,) * 2
    np.testing.assert_allclose(got.kernel, want.kernel, rtol=0, atol=1e-5)
    assert float(got.kernel.sum()) == pytest.approx(1.0, abs=1e-5)
    assert got.spread_pixels == pytest.approx(want.spread_pixels, rel=1e-5)
    assert got.average_fwhm == pytest.approx(want.average_fwhm, rel=1e-4)
    assert abs(got.average_ellipticity - want.average_ellipticity) <= 0.01
    k = tpsf.psf_to_kernel(got)
    np.testing.assert_allclose(k, jpsf.psf_to_kernel(want), rtol=0, atol=1e-5)
    assert float(k.sum()) == pytest.approx(1.0, abs=1e-6)


def test_cutout_average_matches_jax(rng):
    img = star_field(4, 15, hw=160)
    img[40:44, 50:53] = np.nan
    img[90, 90] = np.inf
    xs = rng.uniform(0.0, 159.0, 12).astype(np.float32)
    ys = rng.uniform(0.0, 159.0, 12).astype(np.float32)
    xs[:3] = [2.5, 157.5, 51.0]    # origins clamped at both sides, NaN
    ys[:3] = [3.5, 158.2, 42.0]
    for radius in (4, 15):
        psf, spread = tpsf._cutout_average(_t(img), _t(xs), _t(ys), radius)
        jp, js = jpsf._cutout_average_kernel(
            jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
            jnp.ones(12, bool), radius)
        np.testing.assert_allclose(psf.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-6)
        assert float(spread) == pytest.approx(float(js), rel=1e-6)


def test_score_star_and_candidate_dict():
    kw = dict(x=10.0, y=20.0, peak=0.5, flux=3.0, fwhm=3.2, ellipticity=0.1,
              distance_from_center=120.0, snr=80.0)
    a, b = tpsf.StarCandidate(**kw), jpsf.StarCandidate(**kw)
    assert a.to_dict() == b.to_dict()
    for snr, fwhm, e in ((80.0, 3.2, 0.1), (250.0, 9.0, 0.0),
                         (0.0, 4.0, 0.29)):
        a.snr = b.snr = snr
        a.fwhm = b.fwhm = fwhm
        a.ellipticity = b.ellipticity = e
        assert tpsf.score_star(a) == jpsf.score_star(b)


def test_estimate_psf_refusals():
    flat = np.random.default_rng(0).normal(0.1, 0.001, (96, 96))
    with pytest.raises(InvalidInput, match="No stars detected"):
        tpsf.estimate_psf(_t(flat))
    with pytest.raises(Exception, match="No stars detected"):
        jpsf.estimate_psf(jnp.asarray(flat.astype(np.float32)))
    # stars, but every one at the edge: none passes the filters
    img = star_field(5, 10, hw=96, margin=8)
    cfg = dict(edge_margin=48)
    with pytest.raises(InvalidInput, match="quality filters"):
        tpsf.estimate_psf(_t(img), tpsf.PsfEstimationConfig(**cfg))
    with pytest.raises(Exception, match="quality filters"):
        jpsf.estimate_psf(jnp.asarray(img), jpsf.PsfEstimationConfig(**cfg))


# ---- subframe metrics -------------------------------------------------------


def _same_metrics(got, want):
    assert got.file_path == want.file_path
    assert got.file_name == want.file_name
    assert got.star_count == want.star_count
    assert got.accepted == want.accepted
    for k in ("median_fwhm", "median_snr", "background_median",
              "background_sigma", "noise_ratio", "weight"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-4,
                                                abs=1e-9), k
    assert abs(got.median_eccentricity - want.median_eccentricity) <= 0.01
    assert set(got.to_dict()) == set(want.to_dict())


@pytest.mark.parametrize("kind", ["good", "soft", "elongated", "sparse",
                                  "empty"])
def test_analyze_subframe_matches_jax(kind):
    img = {"good": lambda: star_field(6, 30),
           "soft": lambda: star_field(7, 25, sigma=(3.6, 4.2)),
           "elongated": lambda: star_field(8, 20, ellip=1.5),
           "sparse": lambda: star_field(9, 3),
           "empty": lambda: np.random.default_rng(1).normal(
               0.1, 0.004, (128, 128)).astype(np.float32)}[kind]()
    path = f"/data/night1/{kind}.fits"
    got = tsub.analyze_subframe(_t(img), path)
    want = jsub.analyze_subframe(jnp.asarray(img), path)
    _same_metrics(got, want)
    if kind in ("sparse", "empty"):
        assert got.weight == 0.0 and not got.accepted
    if kind == "good":
        assert got.accepted and got.star_count >= 25


def test_subframe_helpers_match_jax():
    for vals in ([], [3.0], [2.0, 1.0], [5.0, float("nan"), 1.0, 2.0],
                 [float("inf"), 1.0, 4.0]):
        assert tsub._median_of(vals) == jsub._median_of(vals)
    cfgs = [(tsub.SubframeWeightConfig(), jsub.SubframeWeightConfig()),
            (tsub.SubframeWeightConfig(0, 0, 0, 0),
             jsub.SubframeWeightConfig(0, 0, 0, 0)),
            (tsub.SubframeWeightConfig(2.0, 0.1, 0.5, 1.0),
             jsub.SubframeWeightConfig(2.0, 0.1, 0.5, 1.0))]
    for tc, jc in cfgs:
        for args in ((3.0, 0.2, 40.0, 0.05), (0.4, 0.9, 0.5, 0.0),
                     (2.0, 0.0, 0.0, 1.0), (5.0, 1.5, 1.0, 0.2)):
            assert tsub.compute_weight(*args, tc) == \
                jsub.compute_weight(*args, jc)
    tm = [tsub.analyze_subframe(_t(star_field(s, 15)), f"f{s}.fits")
          for s in (10, 11, 12)]
    jm = [jsub.analyze_subframe(jnp.asarray(star_field(s, 15)),
                                f"f{s}.fits") for s in (10, 11, 12)]
    tsub.normalize_weights(tm)
    jsub.normalize_weights(jm)
    for a, b in zip(tm, jm):
        _same_metrics(a, b)
    assert max(m.weight for m in tm) == 1.0
    zero = [tsub.SubframeMetrics("a", "a", 0, 0, 0, 0, 0, 0, 0, 0.0, False)]
    tsub.normalize_weights(zero)
    assert zero[0].weight == 0.0
