"""PyTorch port: the bicubic resize with its WCS rescale
(``imaging/resample.py``) and ``resample_fits_cmd`` against the JAX
package (astroburst_tpu/imaging/resample.py, api/processing.py) on the
same seeded numpy inputs.

Tolerances, and why:

- ``resample_image`` against a numpy oracle that rounds every f32
  product and sum in the same tap order (rows j = 0..3, then columns):
  bit-equal. The port runs each product and sum as its own torch
  operation, so nothing is contracted.
- against JAX: within 2 ulp of the plane's largest magnitude. XLA on
  the CPU may contract ``tmp + w·take`` into an FMA (ROADMAP C13),
  which changes one rounding per tap; where the taps cancel, that is
  many ulps of a small output but never more than an ulp or two of the
  largest term.
- the taps (host f64, weights rounded to f32) and the WCS updates (host
  f64): exactly equal.
- the command: the RES_* keys and ``wcs_updates`` equal, the FITS
  header bytes equal (the same f64 values written), the image as above,
  the preview PNG within one grey level (the auto-STF comes from each
  package's stats, ROADMAP C5) and equal to the port's own STF'd
  downsample of the written image.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu import api as japi
from astroburst_tpu.imaging import resample as jrs
from astroburst_tpu.io.header import HduHeader as JHeader
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api.helpers import save_stf_preview_png
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging import resample as trs
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io import extract_image, write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_io import _decode_png

torch.set_num_threads(1)

CPU = torch.device("cpu")
WCS_CD = [("OBJECT", "TEST"), ("FILTER", "Ha"),
          ("CRPIX1", "48"), ("CRPIX2", "48"), ("CRVAL1", "150.0"),
          ("CRVAL2", "30.0"), ("CD1_1", "-0.0002"), ("CD1_2", "0"),
          ("CD2_1", "0"), ("CD2_2", "0.0002"), ("CTYPE1", "'RA---TAN'")]
WCS_CDELT = [("CRPIX1", "10.5"), ("CRPIX2", "20.25"),
             ("CDELT1", "-2.7777E-4"), ("CDELT2", "2.7777E-4"),
             ("CROTA2", "12.0")]


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _oracle(img, rows, cols):
    """Every product and sum rounded to f32, taps j = 0..3 in order."""
    def axis(x, n_tgt, ax):
        idxs, ws = jrs._axis_taps(x.shape[ax], n_tgt)
        out = None
        for i, w in zip(idxs, ws):
            w = w[:, None] if ax == 0 else w[None, :]
            term = (w * np.take(x, i, axis=ax)).astype(np.float32)
            out = term if out is None else (out + term).astype(np.float32)
        return out
    return axis(axis(img, rows, 0), cols, 1)


SHAPES = [(37, 53, 20, 30), (37, 53, 80, 100), (37, 53, 37, 60),
          (64, 48, 32, 96), (5, 7, 1, 1), (9, 9, 40, 3)]


@pytest.mark.parametrize("h,w,rows,cols", SHAPES)
def test_resample_image_matches_oracle_and_jax(rng, h, w, rows, cols):
    img = rng.normal(0, 1, (h, w)).astype(np.float32)
    img[rng.random(img.shape) < 0.05] *= 40.0
    got = trs.resample_image(torch.from_numpy(img), rows, cols)
    assert got.shape == (rows, cols) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _oracle(img, rows, cols))
    want = np.asarray(jrs.resample_image(jnp.asarray(img), rows, cols))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=2 * ulp, rtol=0)


def test_resample_image_edges():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert trs.resample_image(img, 3, 4) is img     # the shape already
    for bad in ((0, 4), (3, -1)):
        with pytest.raises(InvalidInput, match="must be > 0"):
            trs.resample_image(img, *bad)
    const = torch.full((17, 23), 2.5)
    np.testing.assert_allclose(trs.resample_image(const, 40, 9).numpy(),
                               2.5, rtol=1e-6)


@pytest.mark.parametrize("n_src,n_tgt", [(37, 20), (37, 80), (5655, 8192),
                                         (4096, 2048), (1, 5)])
def test_axis_taps_match_jax(n_src, n_tgt):
    ti, tw = trs._axis_taps(n_src, n_tgt)
    ji, jw = jrs._axis_taps(n_src, n_tgt)
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cards", [WCS_CD, WCS_CDELT, []],
                         ids=["cd", "cdelt", "none"])
def test_wcs_updates_match_jax(rng, cards):
    img = rng.normal(0, 1, (96, 80)).astype(np.float32)
    for dims in ((48, 40), (200, 33)):
        got = trs.resample_with_wcs(torch.from_numpy(img), HduHeader(cards),
                                    *dims)
        want = jrs.resample_with_wcs(img, JHeader(cards), *dims)
        assert got.header_updates == want.header_updates
        assert got.original_dims == want.original_dims == (96, 80)
        assert got.resampled_dims == want.resampled_dims == dims
        np.testing.assert_array_equal(got.image.numpy(),
                                      _oracle(img, *dims))


@pytest.mark.parametrize("cards,size", [(WCS_CD, (40, 48)),
                                        (WCS_CDELT, (150, 130)),
                                        ([], (96, 96))],
                         ids=["cd_down", "cdelt_up", "none_same"])
def test_resample_fits_cmd_matches_jax(tmp_path, rng, cards, size):
    img = np.abs(rng.normal(0.2, 0.01, (96, 96))).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float64)
    for cy, cx in [(30, 30), (60, 70), (70, 20), (20, 70), (48, 48)]:
        img += (0.9 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
                ).astype(np.float32)
    p = str(tmp_path / "stars.fits")
    write_fits_mono(p, img, HduHeader(cards))
    tw, th = size
    got = tapi.resample_fits_cmd(p, str(tmp_path / "t"), tw, th, device=CPU)
    want = japi.resample_fits_cmd(p, str(tmp_path / "j"), tw, th)
    assert set(got) == set(want) == {
        C.RES_FITS_PATH, C.RES_PNG_PATH, C.RES_ORIGINAL_DIMENSIONS,
        C.RES_DIMENSIONS, C.RES_WCS_UPDATES, C.RES_ELAPSED_MS}
    for k in (C.RES_ORIGINAL_DIMENSIONS, C.RES_DIMENSIONS,
              C.RES_WCS_UPDATES):
        assert got[k] == want[k], k
    assert got[C.RES_DIMENSIONS] == [tw, th]
    assert os.path.basename(got[C.RES_FITS_PATH]) == "stars_resampled.fits"
    assert os.path.basename(got[C.RES_PNG_PATH]) == "stars_resampled.png"
    a, b = extract_image(got[C.RES_FITS_PATH]), extract_image(
        want[C.RES_FITS_PATH])
    ulp = np.spacing(np.float32(np.abs(b.image).max()))
    np.testing.assert_allclose(a.image, b.image, atol=2 * ulp, rtol=0)
    np.testing.assert_array_equal(a.image, _oracle(img, th, tw)
                                  if (th, tw) != img.shape else img)
    assert a.header.cards == b.header.cards
    for k, v in got[C.RES_WCS_UPDATES].items():
        if k not in ("NAXIS1", "NAXIS2"):
            assert a.header.get_f64(k) == pytest.approx(v, rel=1e-12)
    png = _decode_png(got[C.RES_PNG_PATH])[0]
    j_png = np.asarray(Image.open(want[C.RES_PNG_PATH]))
    assert png.shape == j_png.shape == (th, tw)
    assert int(np.abs(png.astype(int) - j_png).max()) <= 1
    st = compute_image_stats(torch.from_numpy(a.image))
    again = str(tmp_path / "again.png")
    save_stf_preview_png(torch.from_numpy(a.image), auto_stf(st), st, again)
    np.testing.assert_array_equal(_decode_png(again)[0], png)
