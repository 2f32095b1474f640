"""PyTorch port: the FFT, deconvolution, cube, tile and synth commands
(``compute_fft_spectrum``, ``deconvolve_rl_cmd``, ``process_cube_cmd``,
``process_cube_lazy_cmd``, ``get_cube_info``, ``get_cube_frame``,
``get_cube_spectrum``, ``generate_tiles``, ``generate_tiles_rgb``,
``generate_synth_cmd``, ``generate_synth_stack_cmd``) end to end against
the JAX package's on the CPU, with ``device=torch.device("cpu")``, on
FITS files written here from seeded numpy inputs (64² to 96² planes,
cubes of 8 × 24 × 24 and 40 × 16 × 16).

Tolerances, and why:

- every response's keys equal to JAX's, and its values equal where
  both packages compute them the same way (dimensions, counts, spectra,
  wavelengths, classification, tile levels, star counts);
- the FFT command's header: ``w``, ``h``, ``orig_size`` and ``windowed``
  exact, ``dc`` and ``max`` within 1e-5 of the spectrum's largest value;
  its u8 bytes within one level, equal where the f32 value lies more
  than 1e-3 of a level from an integer
  (tests/test_torch_fft_deconv.py holds the spectrum itself);
- the deconvolved FITS within 5e-5 of the largest value of JAX's,
  ``iterations_run`` equal, ``convergence`` within 1e-3 relative
  (tests/test_torch_fft_deconv.py); the commands' FITS and PNGs
  bit-equal to the port's module calls;
- cube PNGs decoded: bit-equal to the port's own u8 of the same planes,
  within one level of JAX's (JAX's compare-count stats move the
  normalize by less than a level, ROADMAP C21);
- tiles decoded (C16) against the numpy oracle of the reference's STF'd
  pyramid (ROADMAP C1): within one level, equal away from rounding
  boundaries;
- synthetic FITS bit-equal to the port's ``synth.generate`` on the
  same seeds and between two calls; the ground truth within 1e-6 of
  JAX's largest value; the catalogs byte-equal to JAX's.
"""

import importlib
import inspect
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu import api as japi
from astroburst_tpu.api import helpers as jhelpers
from astroburst_tpu.dtypes import ImageStats as JStats
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as JCACHE
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.errors import CacheMiss
from astroburst_tpu_torch.io import (extract_cube, extract_image,
                                     write_fits_mono)
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.reference_impl.stats import ref_stats
from tests.reference_impl.stf import ref_auto_stf
from tests.test_torch_cube import WAVE, make_cube, write_cube
from tests.test_torch_tiles import (bounds_oracle, field, np_downsample_2x,
                                    np_stf)

tapi_cube = importlib.import_module("astroburst_tpu_torch.api.cube")
japi_cube = importlib.import_module("astroburst_tpu.api.cube")

torch.set_num_threads(1)
CPU = torch.device("cpu")
COMMANDS = ("compute_fft_spectrum", "deconvolve_rl_cmd", "process_cube_cmd",
            "process_cube_lazy_cmd", "get_cube_info", "get_cube_frame",
            "get_cube_spectrum", "generate_tiles", "generate_tiles_rgb",
            "generate_synth_cmd", "generate_synth_stack_cmd")


@pytest.fixture(autouse=True)
def _clear_port_state():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()
    for cubes in (tapi_cube._LAZY_CUBES, japi_cube._LAZY_CUBES):
        for c in cubes.values():
            c.close()
        cubes.clear()


def read_png(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def _fits(tmp_path, name, img, cards=(("OBJECT", "'M 42'"),)):
    p = str(tmp_path / f"{name}.fits")
    write_fits_mono(p, img, HduHeader(list(cards)))
    return p


def test_commands_have_the_jax_signature_plus_device():
    for name in COMMANDS:
        got = inspect.signature(getattr(tapi, name)).parameters
        want = inspect.signature(getattr(japi, name)).parameters
        assert list(got)[:-1] == list(want), name
        for p, q in zip(list(got.values())[:-1], want.values()):
            assert (p.kind, p.default) == (q.kind, q.default), (name, p)
        assert (got["device"].kind, got["device"].default) == \
            (inspect.Parameter.KEYWORD_ONLY, None)
        assert name in tapi.__all__


def test_commands_without_a_device_raise_where_there_is_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _fits(tmp_path, "a", field(32, 32, 1, special=False))
    cube = write_cube(tmp_path, make_cube(8, 24, 1))
    out = str(tmp_path / "out")
    calls = {"compute_fft_spectrum": (p,), "deconvolve_rl_cmd": (p, out),
             "process_cube_cmd": (cube, out),
             "process_cube_lazy_cmd": (cube, out),
             "get_cube_info": (cube,), "get_cube_frame": (cube, 0, out),
             "get_cube_spectrum": (cube, 1, 1),
             "generate_tiles": (p, out), "generate_tiles_rgb": (out,),
             "generate_synth_cmd": (out, 32, 32, 5),
             "generate_synth_stack_cmd": (out, 2, 32, 32, 5)}
    assert set(calls) == set(COMMANDS)
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tapi, name)(*args)
    assert GLOBAL_IMAGE_CACHE.keys() == [] and not tapi_cube._LAZY_CUBES
    assert not os.path.exists(out)


# --- FFT spectrum -----------------------------------------------------------


def _parse_fft(blob):
    w, h, dc, mx, _ms, orig, windowed, pad = struct.unpack("<IIffIIII",
                                                           blob[:32])
    return (w, h, orig, windowed, pad), dc, mx, np.frombuffer(
        blob[32:], np.uint8).reshape(h, w)


@pytest.mark.parametrize("shape", [(64, 64), (96, 70), (33, 80)])
def test_compute_fft_spectrum_matches_jax(tmp_path, shape):
    from astroburst_tpu_torch.analysis.fft import compute_power_spectrum
    img = field(*shape, 2)
    p = _fits(tmp_path, "f", img)
    got = tapi.compute_fft_spectrum(p, device=CPU)
    want = japi.compute_fft_spectrum(p)
    assert isinstance(got, bytes) and len(got) == len(want)
    gh, gdc, gmx, gpx = _parse_fft(got)
    wh, wdc, wmx, wpx = _parse_fft(want)
    assert gh == wh
    spec = compute_power_spectrum(torch.from_numpy(img)).spectrum.numpy()
    top = np.abs(spec).max()
    assert abs(gdc - wdc) <= 1e-5 * top and abs(gmx - wmx) <= 1e-5 * top
    mn = float(spec.min())
    scaled = (spec - mn) * (255.0 / max(float(spec.max()) - mn, 1e-10))
    np.testing.assert_array_equal(gpx, scaled.astype(np.uint8))
    assert np.abs(gpx.astype(int) - wpx).max() <= 1
    far = np.abs(scaled - np.round(scaled)) > 1e-3
    np.testing.assert_array_equal(gpx[far], wpx[far])
    assert gmx == np.float32(spec.max())
    assert gdc == spec[spec.shape[0] // 2, spec.shape[1] // 2]


# --- deconvolution ----------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(iterations=5, dering=False,
                                         regularization=0.01,
                                         kernel_size=9, psf_sigma=1.5),
                                dict(iterations=4, fast_precision=True)])
def test_deconvolve_rl_cmd_matches_jax(tmp_path, kw):
    from astroburst_tpu_torch.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu_torch.dtypes import RLConfig
    img = field(64, 72, 3, special=False)
    p = _fits(tmp_path, "m42", img)
    got = tapi.deconvolve_rl_cmd(p, str(tmp_path / "t"), **kw, device=CPU)
    want = japi.deconvolve_rl_cmd(p, str(tmp_path / "j"), **kw)
    assert set(got) == set(want)
    assert got[C.RES_ITERATIONS_RUN] == want[C.RES_ITERATIONS_RUN]
    assert got["convergence"] == pytest.approx(want["convergence"], rel=1e-3)
    assert os.path.basename(got[C.RES_FITS_PATH]) == \
        os.path.basename(want[C.RES_FITS_PATH]) == "m42_deconv.fits"
    assert os.path.basename(got[C.RES_PNG_PATH]) == \
        os.path.basename(want[C.RES_PNG_PATH])
    g = extract_image(got[C.RES_FITS_PATH])
    w = extract_image(want[C.RES_FITS_PATH]).image
    assert np.abs(g.image - w).max() <= 5e-5 * np.abs(w).max()
    assert g.header.get("OBJECT") == "M 42"
    cfg = dict(iterations=kw.get("iterations", 20),
               regularization=kw.get("regularization", 0.0),
               dering=kw.get("dering", True))
    mod = richardson_lucy(torch.from_numpy(img), generate_gaussian_psf(
        kw.get("kernel_size", 15), kw.get("psf_sigma", 2.0)),
        RLConfig(**cfg))
    np.testing.assert_array_equal(g.image, mod.image.numpy())
    stats = compute_image_stats(mod.image)
    from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
    np.testing.assert_array_equal(
        read_png(got[C.RES_PNG_PATH]),
        apply_stf_u8(mod.image, auto_stf(stats), stats).numpy())


def test_deconvolve_with_the_estimated_psf_matches_jax(tmp_path):
    from tests.test_torch_psf_subframe import star_field
    img = star_field(7, 10, hw=96, sep=16.0)
    p = _fits(tmp_path, "stars", img)
    got = tapi.deconvolve_rl_cmd(p, str(tmp_path / "t"), iterations=6,
                                 use_estimated_psf=True, device=CPU)
    want = japi.deconvolve_rl_cmd(p, str(tmp_path / "j"), iterations=6,
                                  use_estimated_psf=True)
    assert set(got) == set(want)
    assert got[C.RES_ITERATIONS_RUN] == want[C.RES_ITERATIONS_RUN] == 6
    g = extract_image(got[C.RES_FITS_PATH]).image
    w = extract_image(want[C.RES_FITS_PATH]).image
    assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


# --- cubes ------------------------------------------------------------------


def _same_keys_and_values(got, want, keys):
    assert set(got) == set(want)
    for k in keys:
        assert got[k] == want[k], k


def _cube_pngs_close(got, want, planes_u8):
    """The port's PNGs bit-equal to its own u8 planes, within one level
    of JAX's."""
    for key, u8 in planes_u8.items():
        a = read_png(got[key])
        np.testing.assert_array_equal(a, u8)
        assert np.abs(a - read_png(want[key])).max() <= 1


@pytest.mark.parametrize("depth,hw,bitpix", [(8, 24, -32), (40, 16, 16),
                                             (40, 16, -32)])
def test_process_cube_cmd_matches_jax(tmp_path, depth, hw, bitpix):
    from astroburst_tpu_torch.cube import eager as te
    cube = make_cube(depth, hw, depth)
    p = write_cube(tmp_path, cube, bitpix=bitpix)
    got = tapi.process_cube_cmd(p, str(tmp_path / "t"), device=CPU)
    want = japi.process_cube_cmd(p, str(tmp_path / "j"))
    _same_keys_and_values(got, want, (
        C.RES_DIMENSIONS, C.RES_FRAME_COUNT, "center_spectrum",
        C.RES_WAVELENGTHS, C.RES_SPECTRAL_CLASSIFICATION))
    assert got[C.RES_DIMENSIONS] == [hw, hw, depth]
    t = torch.from_numpy(extract_cube(p).cube)
    g = te.compute_global_stats(t)
    u8 = {"collapsed_path": tapi_cube._norm_u8(te.collapse_mean(t), g),
          "collapsed_median_path": tapi_cube._norm_u8(te.collapse_median(t),
                                                      g)}
    _cube_pngs_close(got, want, {k: v.numpy() for k, v in u8.items()})
    frames = sorted(os.listdir(got["frames_dir"]))
    assert frames == sorted(os.listdir(want["frames_dir"]))
    step = max(depth // 16, 1)
    for i, name in enumerate(frames):
        a = read_png(os.path.join(got["frames_dir"], name))
        np.testing.assert_array_equal(
            a, tapi_cube._norm_u8(t[i * step], g).numpy())
        b = read_png(os.path.join(want["frames_dir"], name))
        assert np.abs(a - b).max() <= 1
    again = tapi.process_cube_cmd(p, str(tmp_path / "t2"), frame_step=3,
                                  device=CPU)
    assert again[C.RES_FRAME_COUNT] == len(range(0, depth, 3)) == \
        japi.process_cube_cmd(p, str(tmp_path / "j2"),
                              frame_step=3)[C.RES_FRAME_COUNT]


@pytest.mark.parametrize("depth,hw,bitpix", [(8, 24, -32), (40, 16, 16)])
def test_lazy_cube_commands_match_jax(tmp_path, depth, hw, bitpix):
    from astroburst_tpu_torch.cube import eager as te
    from astroburst_tpu_torch.cube.lazy import LazyCube
    cube = make_cube(depth, hw, depth + 1)
    p = write_cube(tmp_path, cube, bitpix=bitpix,
                   cards=WAVE + [("CUNIT3", "'nm'"), ("CRPIX3", "2.0")])
    got = tapi.process_cube_lazy_cmd(p, str(tmp_path / "t"), device=CPU)
    want = japi.process_cube_lazy_cmd(p, str(tmp_path / "j"))
    _same_keys_and_values(got, want, (
        C.RES_DIMENSIONS, C.RES_FRAME_COUNT, "total_frames",
        "center_spectrum", C.RES_WAVELENGTHS,
        C.RES_SPECTRAL_CLASSIFICATION))
    with LazyCube(p) as lc:
        mean = torch.from_numpy(lc.collapse_mean())
        g = te.compute_global_stats(mean)
        u8 = {"collapsed_path": tapi_cube._norm_u8(mean, g).numpy(),
              "collapsed_median_path": tapi_cube._norm_u8(
                  lc.collapse_median(device=CPU), g).numpy()}
    _cube_pngs_close(got, want, u8)
    assert sorted(os.listdir(got["frames_dir"])) == \
        sorted(os.listdir(want["frames_dir"]))

    info = tapi.get_cube_info(p, device=CPU)
    jinfo = japi.get_cube_info(p)
    _same_keys_and_values(info, jinfo, (
        C.RES_NAXIS1, C.RES_NAXIS2, C.RES_NAXIS3, C.RES_BITPIX,
        C.RES_SPECTRAL_CLASSIFICATION, C.RES_WAVELENGTHS))
    assert info[C.RES_BITPIX] == bitpix

    for z in (0, depth - 1):
        fr = tapi.get_cube_frame(p, z, str(tmp_path / "t"), device=CPU)
        jfr = japi.get_cube_frame(p, z, str(tmp_path / "j"))
        _same_keys_and_values(fr, jfr, (C.RES_FRAME_INDEX,
                                        C.RES_DIMENSIONS))
        assert os.path.basename(fr[C.RES_PNG_PATH]) == \
            os.path.basename(jfr[C.RES_PNG_PATH])
        with LazyCube(p) as lc:
            plane = torch.from_numpy(lc.get_frame(z))
        _cube_pngs_close(fr, jfr, {C.RES_PNG_PATH: tapi_cube._norm_u8(
            plane, te.compute_global_stats(plane)).numpy()})

    for x, y in ((1, 2), (hw - 1, 0), (hw // 2, hw // 2)):
        sp = tapi.get_cube_spectrum(p, x, y, device=CPU)
        jsp = japi.get_cube_spectrum(p, x, y)
        _same_keys_and_values(sp, jsp, (C.RES_X, C.RES_Y, C.RES_SPECTRUM,
                                        C.RES_WAVELENGTHS))
    assert len(tapi_cube._LAZY_CUBES) == 1     # one open cube per path


# --- tiles (ROADMAP C1) -----------------------------------------------------


def _tiles_vs_oracle(pyr, levels_vals, tile):
    """Each decoded tile within one level of round(levels_vals), equal
    where the value is more than 1e-3 from a .5 boundary; padding 0."""
    for lv in pyr["levels"]:
        vals = levels_vals[lv["level"]]
        want = np.clip(np.round(vals), 0, 255).astype(np.int64)
        with np.errstate(invalid="ignore"):
            far = np.abs(np.abs(vals - np.floor(vals)) - 0.5) > 1e-3
        for ty in range(lv["rows"]):
            for tx in range(lv["cols"]):
                got = read_png(os.path.join(pyr["base_dir"], str(lv["level"]),
                                            f"{tx}_{ty}.png"))
                sl = np.s_[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
                w, f = want[sl], far[sl]
                h_, w_ = w.shape[:2]
                assert np.abs(got[:h_, :w_] - w).max() <= 1
                np.testing.assert_array_equal(got[:h_, :w_][f], w[f])
                assert not got[h_:].any() and not got[:, w_:].any()


def _levels(planes, n):
    out = [planes]
    for _ in range(1, n):
        out.append([np_downsample_2x(p) for p in out[-1]])
    return out[::-1]


@pytest.mark.parametrize("shape,tile", [((64, 64), 16), ((96, 70), 32)])
def test_generate_tiles_is_the_stf_pyramid(tmp_path, shape, tile):
    img = field(*shape, 4)
    p = _fits(tmp_path, "m42", img)
    got = tapi.generate_tiles(p, str(tmp_path / "t"), tile, device=CPU)
    want = japi.generate_tiles(p, str(tmp_path / "j"), tile)
    assert set(got) == set(want)
    for k in ("tile_size", "original_width", "original_height", "levels"):
        assert got[k] == want[k], k
    assert got["base_dir"] == os.path.join(str(tmp_path / "t"), "m42_tiles")
    assert len(got["levels"]) >= 3
    st = ref_stats(img)
    stretched = np_stf(img, ref_auto_stf(st), st)
    lo, hi = bounds_oracle(stretched)
    inv = np.float32(255.0) / max(np.float32(hi) - np.float32(lo),
                                  np.float32(1e-10))
    vals = [np.where(np.isfinite(p[0]), (p[0] - np.float32(lo)) * inv, 0.0)
            for p in _levels([stretched], len(got["levels"]))]
    _tiles_vs_oracle(got, vals, tile)


def _seed_composite(planes):
    ts = [compute_image_stats(torch.from_numpy(p)) for p in planes]
    thelpers.insert_composite_and_orig(*(torch.from_numpy(p)
                                         for p in planes), *ts)
    jhelpers.insert_composite_and_orig(
        *(jnp.asarray(p) for p in planes),
        *(JStats(**s.to_dict()) for s in ts))


def test_generate_tiles_rgb_is_the_linked_stf_pyramid(tmp_path):
    planes = [field(70, 90, s) for s in (5, 6, 7)]
    _seed_composite(planes)
    try:
        got = tapi.generate_tiles_rgb(str(tmp_path / "t"), 16, device=CPU)
        want = japi.generate_tiles_rgb(str(tmp_path / "j"), 16)
    finally:
        JCACHE.clear()
    assert set(got) == set(want)
    for k in ("tile_size", "original_width", "original_height", "levels"):
        assert got[k] == want[k], k
    sts = [ref_stats(p) for p in planes]
    linked = thelpers.compute_linked_stf(*(ImageStats(**s) for s in sts))
    prm = (linked.shadow, linked.midtone, linked.highlight)
    vals = [np.stack([np_stf(p, prm, st) * np.float32(255.0)
                      for p, st in zip(lv, sts)], -1)
            for lv in _levels(planes, len(got["levels"]))]
    _tiles_vs_oracle(got, vals, 16)
    GLOBAL_IMAGE_CACHE.clear()
    with pytest.raises(CacheMiss):
        tapi.generate_tiles_rgb(str(tmp_path / "t"), device=CPU)


# --- synth ------------------------------------------------------------------


@pytest.mark.parametrize("field_type,psf_type,vignette", [
    (None, None, None), ("king_cluster", "moffat", True),
    ("exponential_disk", "airy", False)])
def test_generate_synth_cmd_matches_jax_and_repeats(tmp_path, field_type,
                                                    psf_type, vignette):
    from astroburst_tpu_torch.api.synth import _build_config
    from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
    from astroburst_tpu_torch.synth import generate
    args = (64, 80, 25, 5, field_type, psf_type, None, 77, vignette)
    got = tapi.generate_synth_cmd(str(tmp_path / "t"), *args, device=CPU)
    want = japi.generate_synth_cmd(str(tmp_path / "j"), *args)
    _same_keys_and_values(got, want, (C.RES_WIDTH, C.RES_HEIGHT,
                                      "star_count"))
    for k in (C.RES_FITS_PATH, C.RES_PNG_PATH, "catalog_path"):
        assert os.path.basename(got[k]) == os.path.basename(want[k])
    with open(got["catalog_path"], "rb") as a, \
            open(want["catalog_path"], "rb") as b:
        assert a.read() == b.read()
    noisy = extract_image(got[C.RES_FITS_PATH]).image
    cfg = _build_config(64, 80, 25, 5, field_type, psf_type, None, 77,
                        vignette, 1)
    mod = generate(cfg, CPU)[0]
    np.testing.assert_array_equal(noisy, mod.numpy())
    stats = compute_image_stats(mod)
    np.testing.assert_array_equal(read_png(got[C.RES_PNG_PATH]),
                                  apply_stf_u8(mod, auto_stf(stats),
                                               stats).numpy())
    again = tapi.generate_synth_cmd(str(tmp_path / "t2"), *args, device=CPU)
    with open(got[C.RES_FITS_PATH], "rb") as a, \
            open(again[C.RES_FITS_PATH], "rb") as b:
        assert a.read() == b.read()


def test_generate_synth_stack_cmd_matches_jax(tmp_path):
    from astroburst_tpu_torch.api.synth import _build_config
    from astroburst_tpu_torch.synth import generate_stack
    args = (3, 72, 64, 20, 11, None, None, 2.5, 31, True)
    got = tapi.generate_synth_stack_cmd(str(tmp_path / "t"), *args,
                                        device=CPU)
    want = japi.generate_synth_stack_cmd(str(tmp_path / "j"), *args)
    _same_keys_and_values(got, want, (C.RES_FRAME_COUNT, "star_count"))
    assert [os.path.basename(p) for p in got[C.RES_FRAMES]] == \
        [os.path.basename(p) for p in want[C.RES_FRAMES]]
    with open(got["catalog_path"], "rb") as a, \
            open(want["catalog_path"], "rb") as b:
        assert a.read() == b.read()
    gt = extract_image(got["ground_truth_path"]).image
    jgt = extract_image(want["ground_truth_path"]).image
    assert np.abs(gt - jgt).max() <= 1e-6 * np.abs(jgt).max()
    frames, mgt, _ = generate_stack(_build_config(72, 64, 20, 11, None, None,
                                                  2.5, 31, True, 3), CPU)
    np.testing.assert_array_equal(gt, mgt.numpy())
    for path, fr in zip(got[C.RES_FRAMES], frames):
        np.testing.assert_array_equal(extract_image(path).image, fr.numpy())
    again = tapi.generate_synth_stack_cmd(str(tmp_path / "t2"), *args,
                                          device=CPU)
    for a, b in zip(got[C.RES_FRAMES], again[C.RES_FRAMES]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
