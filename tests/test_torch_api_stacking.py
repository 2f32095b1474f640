"""PyTorch port: the ``stack`` command against ``astroburst_tpu.api.stack``
on the same FITS files, written here from seeded numpy frames.

Three cases: 6 frames of 130 x 170 with integer shifts and NaN pixels;
the same frames through a directory path; and 130 frames of 48 x 64,
past K3's 128 frames and the cache's 32 entries. The JAX phase
correlation runs with the parabola vertex (``jax_parabola_vertex``,
ROADMAP C8), or the sub-pixel shifts, and with them the images, differ.

Tolerances: the RES_* keys, offsets, frame count and dimensions equal;
the image and rejected count under the flip bound of
tests/test_torch_pipeline.py (3 pixels off by more than 5e-3; past 128
frames 1e-5 of the pixel-frames, at least 3), where a pixel counts as
flipped when it is off by more than 5e-3 and by more than the parity
budget of 1e-5 of its value (BASELINE.md): the 48 x 64 bench frames
are dense with stars of 2e4-4e4 counts, where 5e-3 is 1-3 f32 ulps of
a mean taken in another order; the ``stacked.fits``
header bytes equal; stats within C5 (range/8**6 for the median and
MAD; min, max and mean of the same image exact and rtol 1e-6); PNG
pixels within one grey level, and equal where both sides use the same
image and stats.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import bench
from chip_smoke import bench_shifts
from astroburst_tpu import api as japi
from astroburst_tpu import constants as JC
from astroburst_tpu.io import extract_image as jextract
from astroburst_tpu.ops.stats import compute_image_stats as jstats
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as JCACHE
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import common as tcommon
from astroburst_tpu_torch.api.helpers import save_stf_preview_png
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io import (extract_image, resolve_inputs,
                                     write_fits_mono)
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_io import _decode_png
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
C5 = 8.0 ** -6
KEYS = {JC.RES_FITS_PATH, JC.RES_PNG_PATH, JC.RES_DIMENSIONS,
        JC.RES_FRAME_COUNT, JC.RES_REJECTED_PIXELS, JC.RES_OFFSETS,
        JC.RES_STATS, JC.RES_ELAPSED_MS}


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _write_frames(root, frames):
    os.makedirs(root)
    paths = []
    for k, f in enumerate(frames):
        paths.append(os.path.join(root, f"frame_{k:03d}.fits"))
        write_fits_mono(paths[-1], f, HduHeader(
            [("OBJECT", "'synthetic'"), ("FRAME", str(k)),
             ("EXPTIME", "30.0")]))
    return paths


def _flips(got, want, got_rej, want_rej, max_flips):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flipped = d > np.maximum(5e-3, 1e-5 * np.abs(want))
    assert int(flipped.sum()) <= max_flips, d.max()
    assert abs(int(got_rej) - int(want_rej)) <= max_flips


def _header_bytes(path):
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.index(b"END".ljust(80))
    return blob[:end + 80]


def _compare(got, want, n_frames):
    """The port's response against the JAX command's."""
    assert set(got) == set(want) == KEYS
    assert [list(o) for o in got[C.RES_OFFSETS]] == \
        [list(o) for o in want[C.RES_OFFSETS]]
    assert got[C.RES_FRAME_COUNT] == want[C.RES_FRAME_COUNT] == n_frames
    assert got[C.RES_DIMENSIONS] == want[C.RES_DIMENSIONS]
    img = extract_image(got[C.RES_FITS_PATH]).image
    j_img = jextract(want[C.RES_FITS_PATH]).image
    _flips(img, j_img, got[C.RES_REJECTED_PIXELS],
           want[C.RES_REJECTED_PIXELS],
           max_flips=max(3, int(1e-5 * n_frames * img.size)))
    assert _header_bytes(got[C.RES_FITS_PATH]) == \
        _header_bytes(want[C.RES_FITS_PATH])

    # stats: the port's of its image against JAX's of the same image
    st = got[C.RES_STATS]
    ref = jstats(np.asarray(img))
    assert set(st) == set(want[C.RES_STATS])
    assert (st["min"], st["max"]) == (ref.min, ref.max)
    assert st["mean"] == pytest.approx(ref.mean, rel=1e-6)
    tol = 2 * (ref.max - ref.min) * C5
    for k in ("median", "mad"):
        assert abs(st[k] - getattr(ref, k)) <= tol, k
    assert abs(st["sigma"] - ref.sigma) <= tol * 1.4826

    # the previews: within one level; equal from the same image + stats
    png = _decode_png(got[C.RES_PNG_PATH])[0]
    j_png = np.asarray(Image.open(want[C.RES_PNG_PATH]))
    assert png.shape == j_png.shape
    assert int(np.abs(png.astype(int) - j_png).max()) <= 1
    j_stats = jstats(np.asarray(j_img))
    same = ImageStats(**{k: getattr(j_stats, k) for k in (
        "min", "max", "median", "mad", "sigma", "mean", "valid_count")})
    again = os.path.join(os.path.dirname(got[C.RES_PNG_PATH]), "again.png")
    save_stf_preview_png(torch.from_numpy(j_img), auto_stf(same), same,
                         again)
    np.testing.assert_array_equal(_decode_png(again)[0], j_png)

    # the result is cached under stacked.fits, with its stats and header
    entry = GLOBAL_IMAGE_CACHE.get(got[C.RES_FITS_PATH], CPU)
    assert entry is not None and entry.stats is not None
    np.testing.assert_array_equal(entry.image.numpy(), img)
    assert entry.header.get("FRAME") == "0"
    return img


def test_stack_matches_jax_with_nan_pixels(tmp_path):
    frames = bench.make_frames(6, 130, 170, seed=5)
    frames[2, 10:12, 20:25] = np.nan
    frames[4, 60, 80:83] = np.nan
    paths = _write_frames(str(tmp_path / "in"), frames)
    got = tapi.stack(paths, str(tmp_path / "t"), device=CPU)
    want = japi.stack(paths, str(tmp_path / "j"))
    _compare(got, want, 6)
    assert got[C.RES_OFFSETS] == bench_shifts(6, 130, 170, seed=5).tolist()
    # a warm call: every frame cached, the same result
    entry = tcommon.load_cached(paths[3], CPU)
    assert entry is GLOBAL_IMAGE_CACHE.get(paths[3], CPU)
    np.testing.assert_array_equal(entry.image.numpy(), frames[3])
    n_cached = len(GLOBAL_IMAGE_CACHE.keys())
    again = tapi.stack(paths, str(tmp_path / "t2"), device=CPU)
    assert len(GLOBAL_IMAGE_CACHE.keys()) == n_cached + 1
    assert again[C.RES_OFFSETS] == got[C.RES_OFFSETS]
    np.testing.assert_array_equal(
        extract_image(again[C.RES_FITS_PATH]).image,
        extract_image(got[C.RES_FITS_PATH]).image)


def test_stack_of_a_directory_matches_jax(tmp_path):
    frames = bench.make_frames(5, 96, 112, seed=8)
    frames[1, :4, :4] = np.nan
    src = str(tmp_path / "in")
    paths = _write_frames(src, frames)
    assert resolve_inputs(src) == paths
    got = tapi.stack([src], str(tmp_path / "t"), sigma_low=2.5,
                     sigma_high=3.5, max_iterations=4, device=CPU)
    want = japi.stack([src], str(tmp_path / "j"), sigma_low=2.5,
                      sigma_high=3.5, max_iterations=4)
    _compare(got, want, 5)
    with pytest.raises(InvalidInput):
        tapi.stack([], str(tmp_path / "t"), device=CPU)


def test_stack_past_128_frames_and_the_cache_matches_jax(tmp_path):
    """130 frames: K3's scratch instance on the card, the plain version
    here; the first 98 entries leave the LRU while the command holds
    them."""
    frames = bench.make_frames(130, 48, 64, seed=21)
    frames[7, 3:5, 9] = np.nan
    paths = _write_frames(str(tmp_path / "in"), frames)
    entries = tcommon.load_cached_many(paths, device=CPU)
    assert [e.header.get("FRAME") for e in entries] == \
        [str(k) for k in range(130)]
    assert all(e.stats is not None for e in entries)
    assert sorted(GLOBAL_IMAGE_CACHE.keys()) == paths[-32:]
    GLOBAL_IMAGE_CACHE.clear()
    got = tapi.stack(paths, str(tmp_path / "t"), align=True, device=CPU)
    want = japi.stack(paths, str(tmp_path / "j"))
    _compare(got, want, 130)
    assert len(JCACHE.keys()) == len(GLOBAL_IMAGE_CACHE.keys()) == 32


# ---- calibrate, run_pipeline_cmd, drizzle_stack_cmd ----------------------
#
# Tolerances: the RES_* keys and the flags equal; images as the array
# functions' tests hold them (tests/test_torch_calibration.py: bit-equal
# without a flat, rtol 1e-6 with one, whose mean is a sum in another
# order; tests/test_torch_calibration_pipeline.py for the pipeline;
# tests/test_torch_drizzle.py for the drizzle: offsets 1e-3 px, image
# atol 2e-4 / rtol 1e-6, rejected count equal); FITS header bytes equal;
# stats within C5 of JAX's stats of the same image (as ``_compare``);
# PNG previews within one grey level of JAX's (auto-STF from each
# package's stats) and equal to the port's own STF of the written image.

import base64
import io as _io

from astroburst_tpu.stacking import calibration as jcal
from astroburst_tpu_torch.imaging.stf import apply_stf_u8
from astroburst_tpu_torch.io.png import encode_gray_png
from astroburst_tpu_torch.ops.ipc import nearest_downsample
from astroburst_tpu_torch.ops.stats import compute_image_stats
from tests.test_torch_calibration_pipeline import (_cal_files, _lights,
                                                   flip_bound)
from tests.test_torch_drizzle import _star_frames


def _stats_close(got_stats, img):
    ref = jstats(np.asarray(img))
    assert set(got_stats) == {"min", "max", "mean", "sigma", "median",
                              "mad"}
    assert (got_stats["min"], got_stats["max"]) == (ref.min, ref.max)
    assert got_stats["mean"] == pytest.approx(ref.mean, rel=1e-6)
    tol = 2 * (ref.max - ref.min) * C5
    for k in ("median", "mad"):
        assert abs(got_stats[k] - getattr(ref, k)) <= tol, k


def _preview_close(got_png, want_png, img):
    """Within one level of JAX's preview, equal to the port's STF'd
    downsample of ``img`` with the port's stats."""
    png = _decode_png(got_png)[0]
    j_png = np.asarray(Image.open(want_png))
    assert png.shape == j_png.shape
    assert int(np.abs(png.astype(int) - j_png).max()) <= 1
    t = torch.from_numpy(img)
    st = compute_image_stats(t)
    again = os.path.join(os.path.dirname(got_png), "again.png")
    save_stf_preview_png(t, auto_stf(st), st, again)
    np.testing.assert_array_equal(_decode_png(again)[0], png)


CAL_KEYS = {JC.RES_FITS_PATH, JC.RES_PNG_PATH, JC.RES_DIMENSIONS,
            JC.RES_HAS_BIAS, JC.RES_HAS_DARK, JC.RES_HAS_FLAT,
            JC.RES_STATS, JC.RES_ELAPSED_MS}


@pytest.mark.parametrize("which", ["all", "bias_dark", "none"])
def test_calibrate_command_matches_jax(tmp_path, rng, which):
    paths, (bias, dark, flat) = _cal_files(str(tmp_path / "cal"), rng)
    light = _lights(rng, n=2, masters=(bias, dark, flat))[1]   # a NaN
    lp = str(tmp_path / "light_M42.fits")
    write_fits_mono(lp, light, HduHeader([("OBJECT", "'M 42'"),
                                          ("EXPTIME", "60.0")]))
    kw = {"all": dict(bias_paths=paths["bias"], dark_paths=paths["dark"],
                      flat_paths=paths["flat"], dark_exposure_ratio=0.5),
          "bias_dark": dict(bias_paths=paths["bias"],
                            dark_paths=paths["dark"]),
          "none": {}}[which]
    got = tapi.calibrate(lp, str(tmp_path / "t"), **kw, device=CPU)
    want = japi.calibrate(lp, str(tmp_path / "j"), **kw)
    assert set(got) == set(want) == CAL_KEYS
    for k in (C.RES_DIMENSIONS, C.RES_HAS_BIAS, C.RES_HAS_DARK,
              C.RES_HAS_FLAT):
        assert got[k] == want[k], k
    assert got[C.RES_HAS_FLAT] == (which == "all")
    assert got[C.RES_DIMENSIONS] == [72, 56]
    assert os.path.basename(got[C.RES_FITS_PATH]) == \
        "light_M42_calibrated.fits"
    assert os.path.basename(got[C.RES_PNG_PATH]) == \
        "light_M42_calibrated.png"
    img = extract_image(got[C.RES_FITS_PATH]).image
    j_img = jextract(want[C.RES_FITS_PATH]).image
    if which == "all":
        np.testing.assert_allclose(img, j_img, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(img, j_img)
    assert _header_bytes(got[C.RES_FITS_PATH]) == \
        _header_bytes(want[C.RES_FITS_PATH])
    _stats_close(got[C.RES_STATS], img)
    _preview_close(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH], img)
    # the same masters as the array functions on the same frames
    mb = jcal.create_master_bias(paths["bias"])
    if which == "none":
        np.testing.assert_array_equal(img, np.maximum(light, 0))
    elif which == "bias_dark":
        md = jcal.create_master_dark(paths["dark"], mb)
        np.testing.assert_array_equal(
            img, np.maximum(light - np.asarray(mb) - np.asarray(md), 0))


PIPE_KEYS = {JC.CHANNELS, "stats", JC.RES_HAS_BIAS, JC.RES_HAS_DARK,
             JC.RES_HAS_FLAT, JC.RES_ELAPSED_MS}


def _b64_pixels(b64):
    return np.asarray(Image.open(_io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("normalize", [False, True])
def test_run_pipeline_cmd_matches_jax(tmp_path, rng, normalize):
    paths, masters = _cal_files(str(tmp_path / "cal"), rng)
    chans = []
    for lbl in ("R", "G", "B"):
        lp = []
        for k, f in enumerate(_lights(rng, masters=masters)):
            lp.append(str(tmp_path / f"{lbl}_{k}.fits"))
            write_fits_mono(lp[-1], f)
        chans.append({"label": lbl, "lights": lp})
    kw = dict(bias_paths=paths["bias"], dark_paths=paths["dark"],
              flat_paths=paths["flat"], sigma_low=2.0,
              normalize_before_stack=normalize)
    got = tapi.run_pipeline_cmd(chans, str(tmp_path / "t"), **kw,
                                device=CPU)
    want = japi.run_pipeline_cmd(chans, str(tmp_path / "j"), **kw)
    assert set(got) == set(want) == PIPE_KEYS | {"rgb_fits_path"}
    for k in (C.RES_HAS_BIAS, C.RES_HAS_DARK, C.RES_HAS_FLAT):
        assert got[k] is want[k] is True
    assert set(got["stats"]) == set(want["stats"])
    bound = flip_bound(5, 56 * 72)
    masters_t = []
    for g, w, gs, ws in zip(got[C.CHANNELS], want[C.CHANNELS],
                            got["stats"]["channels"],
                            want["stats"]["channels"]):
        assert set(g) == set(w) == {"label", "fits_path", "preview_b64"}
        assert g["label"] == w["label"]
        assert os.path.basename(g["fits_path"]) == \
            f"master_{g['label']}.fits"
        m = extract_image(g["fits_path"]).image
        jm = jextract(w["fits_path"]).image
        masters_t.append(m)
        assert _header_bytes(g["fits_path"]) == _header_bytes(w["fits_path"])
        if normalize:
            # the flat's mean and each frame's mean are sums in another
            # order: the masters within 1e-5 except flips
            assert int((np.abs(m - jm) > 1e-5).sum()) <= bound
            for k in ("mean", "stddev"):
                assert gs[k] == pytest.approx(ws[k], rel=1e-5)
        else:
            np.testing.assert_allclose(m, jm, rtol=0, atol=2e-6)
            assert gs["lights_after_rejection"] == \
                ws["lights_after_rejection"]
        # the previews: STF'd to u8 first, then the 1024 downsample
        px = _b64_pixels(g["preview_b64"])
        assert int(np.abs(px.astype(int) - _b64_pixels(
            w["preview_b64"])).max()) <= 1
        t = torch.from_numpy(m)
        st = compute_image_stats(t)
        u8 = nearest_downsample(apply_stf_u8(t, auto_stf(st), st), 1024)
        assert base64.b64decode(g["preview_b64"]) == \
            encode_gray_png(u8.numpy())
    rgb = extract_image(got["rgb_fits_path"])
    from astroburst_tpu_torch.io import try_extract_rgb
    planes = try_extract_rgb(got["rgb_fits_path"])
    for p, m in zip((planes.r, planes.g, planes.b), masters_t):
        np.testing.assert_array_equal(p, m)
    assert rgb.image.shape == (56, 72)


def test_run_pipeline_cmd_one_channel_no_masters_matches_jax(tmp_path, rng):
    lp = []
    for k, f in enumerate(_lights(rng, n=4)):
        lp.append(str(tmp_path / f"L_{k}.fits"))
        write_fits_mono(lp[-1], f)
    chans = [{"lights": lp}]
    got = tapi.run_pipeline_cmd(chans, str(tmp_path / "t"),
                                normalize_before_stack=False, device=CPU)
    want = japi.run_pipeline_cmd(chans, str(tmp_path / "j"),
                                 normalize_before_stack=False)
    assert set(got) == set(want) == PIPE_KEYS
    assert got["stats"] == want["stats"]
    assert got[C.CHANNELS][0]["label"] == "L"
    np.testing.assert_array_equal(
        extract_image(got[C.CHANNELS][0]["fits_path"]).image,
        jextract(want[C.CHANNELS][0]["fits_path"]).image)


DRZ_KEYS = {JC.RES_FITS_PATH, JC.RES_PNG_PATH, JC.RES_INPUT_DIMS,
            JC.RES_OUTPUT_DIMS, JC.RES_SCALE, JC.RES_FRAME_COUNT,
            JC.RES_REJECTED_PIXELS, JC.RES_OFFSETS, JC.RES_STATS,
            JC.RES_ELAPSED_MS}


@pytest.mark.parametrize("args", [{}, {"scale": 1.5, "pixfrac": 0.5,
                                       "sigma": 2.5, "sigma_iterations": 3}],
                         ids=["defaults", "scale_1_5"])
def test_drizzle_stack_cmd_matches_jax(tmp_path, rng, args):
    frames, dith = _star_frames(rng, n=5, h=64, w=80)
    frames[2][10:12, 30] = np.nan
    paths = _write_frames(str(tmp_path / "in"), frames)
    got = tapi.drizzle_stack_cmd(paths, str(tmp_path / "t"), **args,
                                 device=CPU)
    want = japi.drizzle_stack_cmd(paths, str(tmp_path / "j"), **args)
    assert set(got) == set(want) == DRZ_KEYS
    for k in (C.RES_INPUT_DIMS, C.RES_OUTPUT_DIMS, C.RES_SCALE,
              C.RES_FRAME_COUNT, C.RES_REJECTED_PIXELS):
        assert got[k] == want[k], k
    scale = args.get("scale", 2.0)
    assert got[C.RES_INPUT_DIMS] == [80, 64]
    assert got[C.RES_OUTPUT_DIMS] == [int(np.ceil(80 * scale)),
                                      int(np.ceil(64 * scale))]
    np.testing.assert_allclose(np.asarray(got[C.RES_OFFSETS]),
                               np.asarray(want[C.RES_OFFSETS]), atol=1e-3)
    # [dx, dy]: each frame's dither (dy, dx) reversed
    np.testing.assert_allclose(np.asarray(got[C.RES_OFFSETS]),
                               dith[:, ::-1], atol=0.15)
    img = extract_image(got[C.RES_FITS_PATH]).image
    j_img = jextract(want[C.RES_FITS_PATH]).image
    np.testing.assert_allclose(img, j_img, atol=2e-4, rtol=1e-6)
    assert _header_bytes(got[C.RES_FITS_PATH]) == \
        _header_bytes(want[C.RES_FITS_PATH])
    _stats_close(got[C.RES_STATS], img)
    _preview_close(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH], img)
