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
