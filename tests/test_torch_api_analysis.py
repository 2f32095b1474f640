"""PyTorch port: the detection and analysis commands (``detect_stars``,
``detect_stars_composite``, ``analyze_subframes_cmd`` in
``api/analysis.py``; ``estimate_psf_cmd`` in ``api/psf.py``) end to end
against the JAX package's, on FITS files written here from seeded numpy
star fields (10–30 stars at least 16–24 px apart, 96² to 192²) and on a
3 × 96² composite seeded in both packages' caches.

Tolerances, and why (the detection's, tests/test_torch_star_detection.py):

- every star list equal to the port's ``detect_stars`` on the same
  plane (the command adds only the payload);
- against JAX: the same stars in the same order, positions, flux, FWHM,
  peak and SNR within rel 1e-4, eccentricity within abs 0.01, npix equal
  (K11's moment sums in another order); the background median and sigma
  within abs 1e-5 / 1e-6;
- the PSF kernel within 1e-5, the spread within 1e-5 relative, the
  selected stars equal (tests/test_torch_psf_subframe.py);
- the subframe metrics within 1e-4 relative, the accept decisions and
  ``accepted_count`` equal.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import api as japi
from astroburst_tpu.api import helpers as jhelpers
from astroburst_tpu.dtypes import ImageStats as JStats
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.analysis import star_detection as tsd
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_psf_subframe import star_field

tpsf = importlib.import_module("astroburst_tpu_torch.imaging.psf_estimation")
tsub = importlib.import_module("astroburst_tpu_torch.analysis.subframe")

torch.set_num_threads(1)

CPU = torch.device("cpu")
STAR_KEYS = ("x", "y", "flux", "fwhm", "eccentricity", "peak", "npix", "snr")


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _fits(tmp_path, name, img):
    p = str(tmp_path / f"{name}.fits")
    write_fits_mono(p, img, HduHeader([("OBJECT", "'field'")]))
    return p


def _stars_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) == set(STAR_KEYS)
        assert a["npix"] == b["npix"]
        for k in ("x", "y", "flux", "fwhm", "peak", "snr"):
            assert a[k] == pytest.approx(b[k], rel=1e-4), k
        assert abs(a["eccentricity"] - b["eccentricity"]) <= 0.01


def _payload_close(got, want):
    assert set(got) == set(want)
    for k in ("star_count", "threshold_sigma", C.RES_WIDTH, C.RES_HEIGHT):
        assert got[k] == want[k], k
    assert got["background_median"] == pytest.approx(
        want["background_median"], abs=1e-5)
    assert got["background_sigma"] == pytest.approx(
        want["background_sigma"], abs=1e-6)
    _stars_equal(got["stars"], want["stars"])


def _module_payload(result):
    return [s.to_dict() for s in result.stars]


@pytest.mark.parametrize("sigma", [None, 5.0, 3.0])
def test_detect_stars_matches_module_and_jax(tmp_path, sigma):
    img = star_field(20, 30, hw=160, sep=18.0)
    img[50:53, 60:64] = np.nan
    img[100, 3] = np.inf
    p = _fits(tmp_path, "f", img)
    got = tapi.detect_stars(p, sigma, device=CPU)
    want = japi.detect_stars(p, sigma)
    _payload_close(got, want)
    mine = tsd.detect_stars(torch.from_numpy(img), sigma or 5.0)
    assert got["stars"] == _module_payload(mine)
    assert got["star_count"] >= 25
    assert got["threshold_sigma"] == (sigma or 5.0)
    # a cache key works as a path, and the cached plane is read
    got2 = tapi.detect_stars(p, sigma, device=CPU)
    assert got2["stars"] == got["stars"]


def _seed_composite(nan=True):
    base = star_field(21, 12, hw=96, margin=8, sep=16.0)
    rng = np.random.default_rng(21)
    planes = [np.clip(base * s + rng.normal(0, 0.002, base.shape), 0, None)
              .astype(np.float32) for s in (1.0, 0.8, 1.2)]
    if nan:
        planes[1][40, 41] = np.nan
    ts = [compute_image_stats(torch.from_numpy(p)) for p in planes]
    thelpers.insert_composite_and_orig(*(torch.from_numpy(p)
                                         for p in planes), *ts)
    jhelpers.insert_composite_and_orig(
        *(jnp.asarray(p) for p in planes),
        *(JStats(**dataclasses.asdict(s)) for s in ts))
    return planes


@pytest.mark.parametrize("nan", [False, True])
def test_detect_stars_composite_matches_module_and_jax(nan):
    """The command's own luminance, 0.2126 r + 0.7152 g + 0.0722 b,
    without scrubbing: a NaN pixel of G stays NaN in the plane the
    detection sees (``synthesize_luminance`` would count that G as 0)."""
    r, g, b = _seed_composite(nan)
    got = tapi.detect_stars_composite(device=CPU)
    want = japi.detect_stars_composite()
    _payload_close(got, want)
    lum = (np.float32(0.2126) * r + np.float32(0.7152) * g
           + np.float32(0.0722) * b)
    assert np.isnan(lum[40, 41]) == nan
    mine = tsd.detect_stars(torch.from_numpy(lum), 5.0)
    assert got["stars"] == _module_payload(mine)
    assert got["star_count"] >= 8
    tms = importlib.import_module(
        "astroburst_tpu_torch.imaging.masked_stretch")
    scrubbed = tms.synthesize_luminance(*(torch.from_numpy(p)
                                          for p in (r, g, b)))
    g0 = np.where(np.isfinite(g), g, np.float32(0.0))
    want_px = (np.float32(0.2126) * r + np.float32(0.7152) * g0
               + np.float32(0.0722) * b)[40, 41]
    assert float(scrubbed[40, 41]) == float(want_px)
    assert np.isfinite(float(scrubbed[40, 41]))


@pytest.mark.parametrize("kw", [{}, dict(num_stars=5, cutout_radius=8),
                                dict(saturation_threshold=0.9,
                                     min_peak_fraction=0.3,
                                     max_ellipticity=0.2)])
def test_estimate_psf_cmd_matches_module_and_jax(tmp_path, kw):
    img = star_field(22, 25)
    p = _fits(tmp_path, "psf", img)
    got = tapi.estimate_psf_cmd(p, **kw, device=CPU)
    want = japi.estimate_psf_cmd(p, **kw)
    assert set(got) == set(want)
    for k in (C.RES_KERNEL_SIZE, C.RES_STARS_REJECTED):
        assert got[k] == want[k], k
    np.testing.assert_allclose(np.array(got[C.RES_KERNEL]),
                               np.array(want[C.RES_KERNEL]), rtol=0,
                               atol=1e-5)
    assert got[C.RES_SPREAD_PIXELS] == pytest.approx(
        want[C.RES_SPREAD_PIXELS], rel=1e-5)
    assert got[C.RES_AVERAGE_FWHM] == pytest.approx(
        want[C.RES_AVERAGE_FWHM], rel=1e-4)
    assert abs(got[C.RES_AVERAGE_ELLIPTICITY] -
               want[C.RES_AVERAGE_ELLIPTICITY]) <= 0.01
    assert len(got[C.RES_STARS_USED]) == len(want[C.RES_STARS_USED]) >= 3
    for a, b in zip(got[C.RES_STARS_USED], want[C.RES_STARS_USED]):
        assert set(a) == set(b)
        assert abs(a["x"] - b["x"]) <= 1e-3 and abs(a["y"] - b["y"]) <= 1e-3
    names = ("num_stars", "cutout_radius", "saturation_threshold",
             "min_peak_fraction", "max_ellipticity")
    defaults = tpsf.PsfEstimationConfig()
    cfg = tpsf.PsfEstimationConfig(**{n: kw.get(n, getattr(defaults, n))
                                      for n in names})
    mine = tpsf.estimate_psf(torch.from_numpy(img), cfg)
    assert got[C.RES_KERNEL] == mine.kernel.tolist()
    assert got[C.RES_STARS_USED] == [s.to_dict() for s in mine.stars_used]
    assert got[C.RES_SPREAD_PIXELS] == mine.spread_pixels


def test_analyze_subframes_cmd_matches_module_and_jax(tmp_path):
    frames = [star_field(30 + i, n, hw=160, sigma=sig, sep=18.0)
              for i, (n, sig) in enumerate([(25, (1.3, 2.0)), (20, (1.5, 2.2)),
                                            (3, (1.3, 2.0)),
                                            (22, (3.6, 4.4)),
                                            (28, (1.2, 1.8))])]
    paths = [_fits(tmp_path, f"sub{i}", f) for i, f in enumerate(frames)]
    for config in (None, {"min_stars": 10, "max_fwhm": 6.0,
                          "snr_weight": 2.0}):
        got = tapi.analyze_subframes_cmd(paths, config, device=CPU)
        want = japi.analyze_subframes_cmd(paths, config)
        assert set(got) == set(want)
        assert got[C.RES_FRAME_COUNT] == want[C.RES_FRAME_COUNT] == 5
        assert got["accepted_count"] == want["accepted_count"]
        assert 1 <= got["accepted_count"] < 5
        cfg = tsub.SubframeWeightConfig(**(config or {}))
        mine = [tsub.analyze_subframe(torch.from_numpy(f), p, cfg)
                for f, p in zip(frames, paths)]
        tsub.normalize_weights(mine)
        assert got[C.RES_FRAMES] == [m.to_dict() for m in mine]
        for a, b in zip(got[C.RES_FRAMES], want[C.RES_FRAMES]):
            assert set(a) == set(b)
            for k in ("file_path", "file_name", "star_count", "accepted"):
                assert a[k] == b[k], k
            for k in ("median_fwhm", "median_snr", "background_median",
                      "background_sigma", "noise_ratio", "weight"):
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-9), k
            assert abs(a["median_eccentricity"] -
                       b["median_eccentricity"]) <= 0.01
    assert tapi.analyze_subframes_cmd([], device=CPU)[C.RES_FRAMES] == []
