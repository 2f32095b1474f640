"""PyTorch port: the stretch, tone, denoise and background commands
(``api/processing.py``) end to end against the JAX package's
(astroburst_tpu/api/processing.py), on FITS files written here from
seeded numpy planes (96² to 128²) and on a 3 × 96² composite seeded in
both packages' caches with the same planes and the same statistics.

Tolerances, and why:

- response dicts: the same key set; every value but ``elapsed_ms`` and
  the paths equal, or within the tolerance of the value below;
- FITS outputs array by array: each equal to the port's own module
  function on the same plane (bit-equal: the command adds nothing but
  the writer), and to JAX's within the module's tolerance
  (tests/test_torch_tone.py, tests/test_torch_wavelet_background.py):
  arcsinh 8 ulp of 1; wavelet the threshold change the noise median's
  error makes (ROADMAP C21); background the model median's error;
- the masked stretch at its default threshold (1e-5, not exposed): the
  iteration count equal to the exact-selection numpy oracle of
  tests/test_torch_masked_stretch.py on the port's own mask; JAX's
  command compared only where it runs as many iterations: the image
  within 1e-5, the same star count, the coverage within 1e-5 (ROADMAP
  C12);
- PNGs as decoded pixels, never bytes (ROADMAP C16): equal to the
  port's own quantisation of its stretched planes, and within one level
  of JAX's, where an f32 value an ulp or two apart (C13, C19) or a
  median within its compare-count error crosses a rounding edge.
"""

import importlib
import inspect
import os

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
from astroburst_tpu_torch.api import processing as tproc
from astroburst_tpu_torch.errors import CacheMiss
from astroburst_tpu_torch.imaging import background as tbg
from astroburst_tpu_torch.imaging import curves as tcur
from astroburst_tpu_torch.imaging import scnr as tscnr
from astroburst_tpu_torch.imaging import stretch as tst
from astroburst_tpu_torch.imaging import wavelet as twv
from astroburst_tpu_torch.imaging.star_mask import _mask_kernel
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, apply_stf_u8, \
    auto_stf
from astroburst_tpu_torch.io import extract_image, write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.dtypes import ScnrConfig, ScnrMethod
from astroburst_tpu_torch.ops.ipc import nearest_downsample
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_api_export import _png_pixels
from tests.test_torch_masked_stretch import _oracle_stretch

tms = importlib.import_module("astroburst_tpu_torch.imaging.masked_stretch")

torch.set_num_threads(1)

CPU = torch.device("cpu")
ULP1 = float(np.spacing(np.float32(1.0)))
RES = 8.0 ** 6
CARDS = [("OBJECT", "'M 42'"), ("FILTER", "'Ha'"), ("EXPTIME", "300.0")]


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def star_plane(seed, h=128, w=128, n=25, bg=0.1, noise=0.004, bad=True,
               slope=0.0):
    """Gaussian stars (FWHM ~4 px, peaks 0.15-0.8) on ``bg`` plus an
    optional linear gradient and noise; NaN, inf and zero pixels when
    ``bad``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = bg + slope * (yy / h + 0.5 * xx / w) + rng.normal(0, noise, (h, w))
    for cy, cx, a in zip(rng.uniform(5, h - 5, n), rng.uniform(5, w - 5, n),
                         rng.uniform(0.15, 0.8, n)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.8 ** 2))
    img = img.astype(np.float32)
    if bad:
        img[3, 4] = np.nan
        img[6, 9] = np.inf
        img[h - 1, :5] = 0.0
    return img


def _fits(tmp_path, name, img):
    p = str(tmp_path / f"{name}.fits")
    write_fits_mono(p, img, HduHeader(CARDS))
    return p


def _dirs(tmp_path):
    return str(tmp_path / "t"), str(tmp_path / "j")


def _keys_equal(got, want, exact=(), skip=()):
    assert set(got) == set(want)
    for k in exact:
        assert got[k] == want[k], k
    for k in got:
        if k.endswith("_path") or k.endswith("_png") or \
                k.endswith("_fits") or k == C.RES_ELAPSED_MS or k in skip:
            continue
        if isinstance(got[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
        else:
            assert got[k] == want[k], k


def _fits_image(path):
    return extract_image(path).image


def _preview_pixels(plane: torch.Tensor):
    """The port's mono preview of a plane: auto-STF u8 of its 4096
    downsample."""
    st = compute_image_stats(plane)
    return apply_stf_u8(nearest_downsample(plane, 4096), auto_stf(st),
                        st).numpy().astype(np.int64)


def _within_one_level(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


# ---- the mono file commands -------------------------------------------------


@pytest.mark.parametrize("factor,gamma", [(50.0, None), (50.0, 2.2),
                                          (0.5, 1.0), (900.0, None)])
def test_apply_arcsinh_stretch_cmd_matches_jax(tmp_path, factor, gamma):
    img = star_plane(1)
    p = _fits(tmp_path, "m", img)
    a, b = _dirs(tmp_path)
    got = tapi.apply_arcsinh_stretch_cmd(p, a, factor, gamma, device=CPU)
    want = japi.apply_arcsinh_stretch_cmd(p, b, factor, gamma)
    _keys_equal(got, want, exact=(C.RES_STRETCH_FACTOR, C.RES_DIMENSIONS))
    assert got[C.RES_STRETCH_FACTOR] == min(max(factor, 1.0), 500.0)
    assert got[C.RES_FITS_PATH] == os.path.join(a, "m_arcsinh.fits")
    out = _fits_image(got[C.RES_FITS_PATH])
    st = compute_image_stats(torch.from_numpy(img))
    mine = tst.arcsinh_stretch_with_stats(torch.from_numpy(img), st.min,
                                          st.max, got[C.RES_STRETCH_FACTOR],
                                          gamma or 1.0)
    np.testing.assert_array_equal(out, mine.numpy())
    np.testing.assert_allclose(out, _fits_image(want[C.RES_FITS_PATH]),
                               rtol=0, atol=8 * ULP1)
    assert extract_image(got[C.RES_FITS_PATH]).header.get("OBJECT") == "M 42"
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _preview_pixels(mine))
    _within_one_level(px, _png_pixels(want[C.RES_PNG_PATH]))


@pytest.mark.parametrize("kw", [{}, {"num_scales": 3,
                                     "thresholds": [4.0, 2.0],
                                     "linear_denoise": False}])
def test_wavelet_denoise_cmd_matches_jax(tmp_path, kw):
    img = star_plane(2, 96, 112)
    p = _fits(tmp_path, "w", img)
    a, b = _dirs(tmp_path)
    got = tapi.wavelet_denoise_cmd(p, a, **kw, device=CPU)
    want = japi.wavelet_denoise_cmd(p, b, **kw)
    _keys_equal(got, want, exact=(C.RES_SCALES_PROCESSED,),
                skip=(C.RES_NOISE_ESTIMATE,))
    assert got[C.RES_FITS_PATH] == os.path.join(a, "w_denoised.fits")
    cfg = twv.WaveletConfig(kw.get("num_scales", 5),
                            tuple(kw.get("thresholds", (3.0, 2.5, 2.0, 1.5,
                                                        1.0))),
                            kw.get("linear_denoise", True))
    mine = twv.wavelet_denoise(torch.from_numpy(img), cfg)
    assert got[C.RES_NOISE_ESTIMATE] == mine.noise_estimate
    out = _fits_image(got[C.RES_FITS_PATH])
    np.testing.assert_array_equal(out, mine.denoised.numpy())
    # JAX: the noise median within its compare-count error, the image
    # within the threshold change it makes (soft) or flips in its band
    with np.errstate(invalid="ignore"):
        d0 = img - twv.atrous_smooth(torch.from_numpy(img), 1).numpy()
    top = float(np.abs(d0[np.isfinite(d0)]).max())
    dn = abs(got[C.RES_NOISE_ESTIMATE] - want[C.RES_NOISE_ESTIMATE])
    assert dn <= 2.0 * top / RES * 1.4826
    diff = np.abs(out - _fits_image(want[C.RES_FITS_PATH]))
    if cfg.linear_denoise:
        dthr = dn * sum(t * twv.atrous_noise_scaling(i) for i, t in
                        enumerate(cfg.thresholds))
        assert diff.max() <= dthr + 8 * ULP1 * float(np.abs(out).max())
    else:
        assert (diff > 8 * ULP1 * float(np.abs(out).max())).mean() < 0.01
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _preview_pixels(mine.denoised))
    jpx = _png_pixels(want[C.RES_PNG_PATH])
    assert px.shape == jpx.shape and (px != jpx).mean() < 0.01


@pytest.mark.parametrize("mode", [None, "subtract", "divide"])
def test_extract_background_cmd_matches_jax(tmp_path, mode):
    img = star_plane(3, slope=0.05)
    p = _fits(tmp_path, "bgtest", img)
    a, b = _dirs(tmp_path)
    got = tapi.extract_background_cmd(p, a, grid_size=8, mode=mode,
                                      device=CPU)
    want = japi.extract_background_cmd(p, b, grid_size=8, mode=mode)
    _keys_equal(got, want, exact=(C.RES_SAMPLE_COUNT,))
    assert got[C.RES_CORRECTED_FITS] == os.path.join(a, "bgtest_bg.fits")
    assert got[C.RES_MODEL_PNG] == os.path.join(a, "bgtest_bg_model.png")
    mine = tbg.extract_background(torch.from_numpy(img), tbg.BackgroundConfig(
        mode=mode or "subtract"))
    out = _fits_image(got[C.RES_CORRECTED_FITS])
    np.testing.assert_array_equal(out, mine.corrected.numpy())
    jout = _fits_image(want[C.RES_CORRECTED_FITS])
    fin = np.isfinite(out)
    np.testing.assert_array_equal(fin, np.isfinite(jout))
    model = mine.model.numpy()
    med_err = 2.0 * float(model.max() - model.min()) / RES
    scale = 2.0 if mode == "divide" else 1.0   # image/model ≤ 2 here
    assert np.abs(out[fin] - jout[fin]).max() <= \
        scale * (med_err + 1e-6 * float(np.abs(model).max())) + \
        8 * ULP1 * float(np.abs(out[fin]).max())
    px = _png_pixels(got[C.RES_CORRECTED_PNG])
    np.testing.assert_array_equal(px, _preview_pixels(mine.corrected))
    _within_one_level(px, _png_pixels(want[C.RES_CORRECTED_PNG]))
    px = _png_pixels(got[C.RES_MODEL_PNG])
    np.testing.assert_array_equal(px, _preview_pixels(mine.model))
    _within_one_level(px, _png_pixels(want[C.RES_MODEL_PNG]))


def test_masked_stretch_cmd_matches_module_oracle_and_jax(tmp_path):
    img = star_plane(4, 128, 128, n=30)
    p = _fits(tmp_path, "ms", img)
    a, b = _dirs(tmp_path)
    got = tapi.masked_stretch_cmd(p, a, device=CPU)
    want = japi.masked_stretch_cmd(p, b)
    assert set(got) == set(want)
    assert got[C.RES_FITS_PATH] == os.path.join(a, "ms_masked_stretch.fits")
    cfg = tproc._masked_stretch_config(None, None, None, None, None, None)
    mine = tms.masked_stretch(torch.from_numpy(img), cfg)
    out = _fits_image(got[C.RES_FITS_PATH])
    np.testing.assert_array_equal(out, mine.image.numpy())
    for k, v in ((C.RES_ITERATIONS_RUN, mine.iterations_run),
                 (C.RES_FINAL_BACKGROUND, mine.final_background),
                 (C.RES_STARS_MASKED, mine.stars_masked),
                 (C.RES_MASK_COVERAGE, mine.mask_coverage),
                 (C.RES_CONVERGED, mine.converged)):
        assert got[k] == v, k
    # the iteration count of the exact-selection oracle on the port's mask
    t = torch.from_numpy(img)
    packed = tsd._detect(t, tsd._tile_size(*img.shape), 5.0, 4096)
    xs, ys, radii, _ = tms._paint_records(packed, tms._mask_config(cfg))
    mask, _ = _mask_kernel(t, xs, ys, radii, 4.0, 0.85, True)
    o_img, o_run, o_conv, o_bg = _oracle_stretch(img, mask.numpy(), cfg)
    assert (got[C.RES_ITERATIONS_RUN], got[C.RES_CONVERGED]) == \
        (o_run, o_conv)
    assert got[C.RES_FINAL_BACKGROUND] == float(o_bg)
    np.testing.assert_allclose(out, o_img, rtol=0, atol=1e-6)
    assert got[C.RES_STARS_MASKED] == want[C.RES_STARS_MASKED] > 10
    assert got[C.RES_MASK_COVERAGE] == pytest.approx(
        want[C.RES_MASK_COVERAGE], abs=1e-5)
    if got[C.RES_ITERATIONS_RUN] == want[C.RES_ITERATIONS_RUN]:
        np.testing.assert_allclose(out, _fits_image(want[C.RES_FITS_PATH]),
                                   rtol=0, atol=1e-5)
        assert got[C.RES_CONVERGED] == want[C.RES_CONVERGED]
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _preview_pixels(mine.image))


@pytest.mark.parametrize("kw", [dict(iterations=4, target_background=0.2),
                                dict(mask_growth=3.0, mask_softness=2.0,
                                     protection_amount=0.5,
                                     luminance_protect=False)])
def test_masked_stretch_cmd_options(tmp_path, kw):
    img = star_plane(5, 96, 96, n=15)
    p = _fits(tmp_path, "ms", img)
    got = tapi.masked_stretch_cmd(p, str(tmp_path / "t"), **kw, device=CPU)
    names = ("iterations", "target_background", "mask_growth",
             "mask_softness", "protection_amount", "luminance_protect")
    cfg = tproc._masked_stretch_config(*(kw.get(n) for n in names))
    mine = tms.masked_stretch(torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(_fits_image(got[C.RES_FITS_PATH]),
                                  mine.image.numpy())
    assert got[C.RES_ITERATIONS_RUN] == mine.iterations_run <= \
        kw.get("iterations", 10)


def test_masked_stretch_config_defaults_match_jax():
    from astroburst_tpu.api import processing as jproc
    import dataclasses
    args = [(None,) * 6, (3, 0.2, 1.5, 2.0, 0.6, False)]
    for a in args:
        assert dataclasses.asdict(tproc._masked_stretch_config(*a)) == \
            dataclasses.asdict(jproc._masked_stretch_config(*a))


# ---- the composite commands -------------------------------------------------


def _seed_composite(h=96, w=96, nan=True):
    base = star_plane(6, h, w, n=18, bad=False)
    rng = np.random.default_rng(16)
    planes = [np.clip(base * s + rng.normal(0, 0.002, base.shape), 0, None)
              .astype(np.float32) for s in (1.0, 0.8, 1.2)]
    if nan:
        planes[1][7, 11] = np.nan
    ts = [compute_image_stats(torch.from_numpy(p)) for p in planes]
    thelpers.insert_composite_and_orig(*(torch.from_numpy(p)
                                         for p in planes), *ts)
    jhelpers.insert_composite_and_orig(
        *(jnp.asarray(p) for p in planes),
        *(JStats(**dataclasses_asdict(s)) for s in ts))
    return planes, ts


def dataclasses_asdict(s):
    import dataclasses
    return dataclasses.asdict(s)


def _rgb_pixels(planes):
    return np.stack([thelpers._to_u8(nearest_downsample(p, 4096)).numpy()
                     for p in planes], -1).astype(np.int64)


def test_arcsinh_stretch_composite_cmd_matches_jax(tmp_path):
    planes, _ = _seed_composite()
    a, b = _dirs(tmp_path)
    got = tapi.arcsinh_stretch_composite_cmd(a, 30.0, device=CPU)
    want = japi.arcsinh_stretch_composite_cmd(b, 30.0)
    _keys_equal(got, want, exact=(C.RES_STRETCH_FACTOR, C.RES_DIMENSIONS))
    assert os.path.basename(got[C.RES_PNG_PATH]).startswith(
        "composite_arcsinh_")
    mine = tst.arcsinh_stretch_rgb(*(torch.from_numpy(p) for p in planes),
                                   30.0)
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _rgb_pixels(mine))
    _within_one_level(px, _png_pixels(want[C.RES_PNG_PATH]))


@pytest.mark.parametrize("shared", [False, True])
def test_masked_stretch_composite_cmd_matches_module_and_jax(tmp_path,
                                                             shared):
    planes, _ = _seed_composite()
    a, b = _dirs(tmp_path)
    got = tapi.masked_stretch_composite_cmd(a, shared_mask=shared,
                                            device=CPU)
    want = japi.masked_stretch_composite_cmd(b, shared_mask=shared)
    assert set(got) == set(want)
    assert got["mask_mode"] == want["mask_mode"] == \
        ("shared_luminance" if shared else "per_channel")
    cfg = tproc._masked_stretch_config(None, None, None, None, None, None)
    tp = [torch.from_numpy(p) for p in planes]
    if shared:
        res = tms.masked_stretch_rgb_shared(*tp, cfg)
        chans = [res[c] for c in "rgb"]
        assert got[C.RES_STARS_MASKED] == res["shared_stars_masked"]
        assert got[C.RES_MASK_COVERAGE] == res["shared_mask_coverage"]
    else:
        chans = [tms.masked_stretch(p, cfg) for p in tp]
        assert got[C.RES_STARS_MASKED] == sum(r.stars_masked for r in chans)
        assert got[C.RES_MASK_COVERAGE] == sum(
            r.mask_coverage for r in chans) / 3.0
    for c, r in zip("rgb", chans):
        assert got[C.CHANNELS][c] == {
            C.RES_ITERATIONS_RUN: r.iterations_run,
            C.RES_FINAL_BACKGROUND: r.final_background,
            C.RES_CONVERGED: r.converged}
        assert set(got[C.CHANNELS][c]) == set(want[C.CHANNELS][c])
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _rgb_pixels([r.image for r in chans]))
    assert got[C.RES_STARS_MASKED] == want[C.RES_STARS_MASKED]
    assert got[C.RES_MASK_COVERAGE] == pytest.approx(
        want[C.RES_MASK_COVERAGE], abs=1e-5)
    same_iters = all(got[C.CHANNELS][c][C.RES_ITERATIONS_RUN] ==
                     want[C.CHANNELS][c][C.RES_ITERATIONS_RUN] for c in "rgb")
    if same_iters:
        for c in "rgb":
            assert got[C.CHANNELS][c][C.RES_FINAL_BACKGROUND] == \
                pytest.approx(want[C.CHANNELS][c][C.RES_FINAL_BACKGROUND],
                              abs=1e-5)
        jpx = _png_pixels(want[C.RES_PNG_PATH])
        assert np.abs(px - jpx).max() <= 1


TONE_CASES = {
    "defaults": {},
    "linked_levels_curve_scnr": dict(
        linked_stf=True, levels_r={"black": 0.05, "gamma": 1.4,
                                   "white": 0.95},
        curves_g={"points": [[0.0, 0.0], [0.4, 0.55], [1.0, 1.0]]},
        scnr={"method": "maximum", "amount": 0.8,
              "preserveLuminance": True}),
    "manual_stf": dict(stf_r=[0.01, 0.3, 1.0], stf_g=[0.0, 0.25, 0.9]),
    "identity_levels_and_curves": dict(
        levels_b={"black": 0.0, "gamma": 1.0, "white": 1.0},
        curves_r={"points": [[0.0, 0.0], [1.0, 1.0]]}, curves_b={}),
    "scnr_off_amount": dict(scnr={"amount": 0.0}),
    "scnr_average": dict(scnr={}),
    "curves_only": dict(curves_b={"points": [[0.5, 0.7]]}),
}


@pytest.mark.parametrize("case", sorted(TONE_CASES))
def test_apply_tone_composite_cmd_matches_module_and_jax(tmp_path, case):
    kw = TONE_CASES[case]
    planes, stats = _seed_composite()
    a, b = _dirs(tmp_path)
    got = tapi.apply_tone_composite_cmd(a, **kw, device=CPU)
    want = japi.apply_tone_composite_cmd(b, **kw)
    _keys_equal(got, want, exact=(C.RES_COMPOSITE_DIMS, C.RES_STF_APPLIED,
                                  C.RES_LEVELS_APPLIED,
                                  C.RES_CURVES_APPLIED, C.RES_SCNR_APPLIED,
                                  C.RES_STF))
    assert got[C.RES_LEVELS_APPLIED] == ("levels_r" in kw)
    assert got[C.RES_CURVES_APPLIED] == (case in ("linked_levels_curve_scnr",
                                                  "curves_only"))
    assert got[C.RES_SCNR_APPLIED] == ("scnr" in kw)
    # the port's pipeline on the same planes
    tp = [torch.from_numpy(p) for p in planes]
    if kw.get("linked_stf"):
        prm, comb = thelpers.compute_linked_stf_with_stats(*stats)
        prms, norms = [prm] * 3, [comb] * 3
    else:
        prms, norms = [auto_stf(s) for s in stats], stats
    for i, key in enumerate(("stf_r", "stf_g", "stf_b")):
        if key in kw:
            from astroburst_tpu_torch.dtypes import StfParams
            prms[i] = StfParams(*kw[key])
    assert got[C.RES_STF] == prms[0].to_dict()
    out = [apply_stf_f32(p, q, n) for p, q, n in zip(tp, prms, norms)]
    if got[C.RES_LEVELS_APPLIED]:
        lv = [tproc._levels_of(kw.get(k)) for k in ("levels_r", "levels_g",
                                                    "levels_b")]
        out = list(tcur.apply_levels_rgb(*out, *lv))
    if got[C.RES_CURVES_APPLIED]:
        pts = [tproc._points_of(kw.get(k)) or [(0.0, 0.0), (1.0, 1.0)]
               for k in ("curves_r", "curves_g", "curves_b")]
        out = list(tcur.apply_curve_rgb(*out, *(tcur.SplineCurve(p)
                                                for p in pts)))
    if "scnr" in kw:
        s = kw["scnr"]
        out = list(tscnr.apply_scnr(*out, ScnrConfig(
            ScnrMethod.parse(s.get("method")), s.get("amount", 1.0),
            bool(s.get("preserveLuminance")))))
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _rgb_pixels(out))
    _within_one_level(px, _png_pixels(want[C.RES_PNG_PATH]))


def test_parse_scnr_config_matches_jax():
    for args in ((False, "max", 0.5, True), (None, None, None, None),
                 (True, None, None, None), (True, "maximum", 0.3, True),
                 (True, "average", None, False), (True, "x", 2.0, None)):
        got = thelpers.parse_scnr_config(*args)
        want = jhelpers.parse_scnr_config(*args)
        if want is None:
            assert got is None
            continue
        assert (got.method.value, got.amount, got.preserve_luminance) == \
            (want.method.value, want.amount, want.preserve_luminance)


# ---- device policy ----------------------------------------------------------


SLICE_COMMANDS = {
    "wavelet_denoise_cmd": lambda p, o: tapi.wavelet_denoise_cmd(p, o),
    "apply_arcsinh_stretch_cmd": lambda p, o:
        tapi.apply_arcsinh_stretch_cmd(p, o, 50.0),
    "masked_stretch_cmd": lambda p, o: tapi.masked_stretch_cmd(p, o),
    "arcsinh_stretch_composite_cmd": lambda p, o:
        tapi.arcsinh_stretch_composite_cmd(o, 30.0),
    "masked_stretch_composite_cmd": lambda p, o:
        tapi.masked_stretch_composite_cmd(o),
    "apply_tone_composite_cmd": lambda p, o:
        tapi.apply_tone_composite_cmd(o),
    "extract_background_cmd": lambda p, o:
        tapi.extract_background_cmd(p, o),
    "detect_stars": lambda p, o: tapi.detect_stars(p),
    "detect_stars_composite": lambda p, o: tapi.detect_stars_composite(),
    "analyze_subframes_cmd": lambda p, o: tapi.analyze_subframes_cmd([p]),
    "estimate_psf_cmd": lambda p, o: tapi.estimate_psf_cmd(p),
}


@pytest.mark.parametrize("cmd", sorted(SLICE_COMMANDS))
def test_command_without_a_card_raises(tmp_path, monkeypatch, cmd):
    """With no device named and no card, each command raises before any
    work, also with the composite seeded on the CPU."""
    p = _fits(tmp_path, "in", star_plane(7, 64, 64, n=6))
    _seed_composite(64, 64)
    keys = GLOBAL_IMAGE_CACHE.keys()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        SLICE_COMMANDS[cmd](p, out)
    assert not os.path.exists(out)
    assert GLOBAL_IMAGE_CACHE.keys() == keys


@pytest.mark.parametrize("cmd", ["arcsinh_stretch_composite_cmd",
                                 "masked_stretch_composite_cmd",
                                 "apply_tone_composite_cmd",
                                 "detect_stars_composite"])
def test_composite_on_another_device_is_a_cache_miss(tmp_path, cmd):
    """A composite held for the CPU is missing for another device."""
    _seed_composite(64, 64)
    other = torch.device("meta")
    call = {"arcsinh_stretch_composite_cmd": lambda:
            tapi.arcsinh_stretch_composite_cmd(str(tmp_path), 30.0,
                                               device=other),
            "masked_stretch_composite_cmd": lambda:
            tapi.masked_stretch_composite_cmd(str(tmp_path), device=other),
            "apply_tone_composite_cmd": lambda:
            tapi.apply_tone_composite_cmd(str(tmp_path), device=other),
            "detect_stars_composite": lambda:
            tapi.detect_stars_composite(device=other)}[cmd]
    with pytest.raises(CacheMiss, match="__composite_r"):
        call()
    GLOBAL_IMAGE_CACHE.clear()
    with pytest.raises(CacheMiss):
        getattr(tapi, cmd)(*(() if cmd == "detect_stars_composite" else
                             (str(tmp_path),) + ((30.0,) if "arcsinh" in cmd
                                                 else ())), device=CPU)


def test_slice_commands_have_the_jax_signature_plus_device():
    for name in SLICE_COMMANDS:
        got = inspect.signature(getattr(tapi, name)).parameters
        want = inspect.signature(getattr(japi, name)).parameters
        assert list(got)[:-1] == list(want), name
        for p, q in zip(list(got.values())[:-1], want.values()):
            assert (p.kind, p.default) == (q.kind, q.default), (name, p)
        assert (got["device"].kind, got["device"].default) == \
            (inspect.Parameter.KEYWORD_ONLY, None)
