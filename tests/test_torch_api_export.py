"""PyTorch port: the export commands (``api/export.py``) against the JAX
package's (astroburst_tpu/api/export.py) on the same FITS files, written
here from seeded numpy planes, and the refusal of every command of this
slice to run without a card when no device is named.

Tolerances, and why:

- RES_* keys and every value but ``elapsed_ms``: equal (the file sizes
  too: the same header and BITPIX give the same bytes).
- FITS written without the STF: the files byte-equal (the same f32
  plane through byte-equal writers, tests/test_torch_io.py); with the
  STF: the image within 2e-6 absolute (an STF'd plane in [0, 1]; JAX's
  XLA may contract the STF's f32 multiply-adds into FMAs, ROADMAP C13,
  while the min and max it scales by are exact in both), and at BITPIX
  16 within one quantum (BSCALE) plus that.
- PNGs: decoded pixels, never bytes (ROADMAP C16): equal without the
  STF (the same host numpy arithmetic on the same f32 plane); with it
  within one level at 8 bits and 2⁸ levels at 16 bits where JAX's FMA
  moves the f32 value by an ulp or two (C13: up to a few ulps where the
  MTF is steep), and equal to the port's own decoded quantisation of
  its stretched plane.
- the resample route of ``export_fits_rgb``: within 2 ulp of the
  plane's largest magnitude (tests/test_torch_resample.py).
"""

import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu import api as japi
from astroburst_tpu.api import helpers as jhelpers
from astroburst_tpu.ops.stats import compute_image_stats as jstats
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as JCACHE
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import export as tex
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.imaging.stf import apply_stf_f32
from astroburst_tpu_torch.io import (extract_image, try_extract_rgb,
                                     write_fits_mono, write_fits_rgb)
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_io import _decode_png

torch.set_num_threads(1)

CPU = torch.device("cpu")
CARDS = [("OBJECT", "'M 42'"), ("FILTER", "'Ha'"), ("EXPTIME", "300.0"),
         ("CRPIX1", "48"), ("CRPIX2", "40"), ("CRVAL1", "83.8"),
         ("CRVAL2", "-5.4"), ("CD1_1", "-0.0002"), ("CD1_2", "0"),
         ("CD2_1", "0"), ("CD2_2", "0.0002"), ("CTYPE1", "'RA---TAN'")]


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _plane(rng, h=80, w=96, bad=True):
    img = np.abs(rng.normal(0.2, 0.02, (h, w))).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(8):
        cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
        img += (rng.uniform(0.3, 3.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)).astype(np.float32)
    if bad:
        img[3, 4] = np.nan
        img[5, 6] = np.inf
        img[7, 8] = -np.inf
        img[:2, :] = 0.0         # padding
    return img


def _fits(path, img, cards=CARDS):
    write_fits_mono(path, img, HduHeader(cards))
    return path


def _same_response(got, want, keys):
    assert set(got) == set(want) == keys | {C.RES_ELAPSED_MS}
    for k in keys:
        assert got[k] == want[k], k


def _png_pixels(path):
    """Decoded pixels of a PNG from either package: the port's writer
    and the JAX 16-bit RGB writer use filter 0 (decoded with zlib);
    Pillow files by Pillow."""
    try:
        return _decode_png(path)[0].astype(np.int64)
    except AssertionError:
        return np.asarray(Image.open(path)).astype(np.int64)


FITS_KEYS = {C.RES_OUTPUT_PATH, C.RES_BITPIX, C.RES_APPLY_STF, C.COPY_WCS,
             C.RES_COPY_METADATA, C.RES_FILE_SIZE_BYTES}


@pytest.mark.parametrize("bitpix", [-32, 16, -64])
@pytest.mark.parametrize("stf", [False, True])
def test_export_fits_matches_jax(tmp_path, rng, bitpix, stf):
    img = _plane(rng)
    p = _fits(str(tmp_path / "in.fits"), img)
    kw = dict(apply_stf_stretch=stf, shadow=0.01 if stf else None,
              midtone=0.2 if stf else None, bitpix=bitpix)
    a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    got = tapi.export_fits(p, a, **kw, device=CPU)
    want = japi.export_fits(p, b, **kw)
    assert got[C.RES_OUTPUT_PATH] == a
    got[C.RES_OUTPUT_PATH] = b
    _same_response(got, want, FITS_KEYS)
    ta, tb = extract_image(a), extract_image(b)
    assert ta.header.cards == tb.header.cards
    if not stf:
        assert open(a, "rb").read() == open(b, "rb").read()
        return
    quantum = float(tb.header.get_f64("BSCALE")) if bitpix == 16 else 0.0
    np.testing.assert_allclose(ta.image, tb.image, atol=quantum + 2e-6,
                               rtol=0)
    assert np.nanmax(ta.image) <= 1.0 + quantum


@pytest.mark.parametrize("wcs,meta", [(True, False), (False, True),
                                      (False, False)])
def test_export_fits_header_filter_matches_jax(tmp_path, rng, wcs, meta):
    p = _fits(str(tmp_path / "in.fits"), _plane(rng))
    a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    got = tapi.export_fits(p, a, copy_wcs=wcs, copy_metadata=meta,
                           device=CPU)
    want = japi.export_fits(p, b, copy_wcs=wcs, copy_metadata=meta)
    got[C.RES_OUTPUT_PATH] = b
    _same_response(got, want, FITS_KEYS)
    assert open(a, "rb").read() == open(b, "rb").read()
    keys = [k for k, _ in extract_image(a).header.cards]
    assert ("CD1_1" in keys) == wcs and ("OBJECT" in keys) == meta


def test_export_fits_takes_the_cached_plane(tmp_path, rng):
    """A path in the image cache exports the cached plane (a stacked or
    processed result), not the file's."""
    img = _plane(rng)
    p = _fits(str(tmp_path / "in.fits"), img)
    cached = img * 2.0 + 1.0
    GLOBAL_IMAGE_CACHE.insert(p, torch.from_numpy(cached),
                              stats=compute_image_stats(
                                  torch.from_numpy(cached)))
    JCACHE.insert(p, jnp.asarray(cached), stats=jstats(jnp.asarray(cached)))
    a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    tapi.export_fits(p, a, device=CPU)
    japi.export_fits(p, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(extract_image(a).image, cached)


RGB_KEYS = {C.RES_OUTPUT_PATH, C.RES_BITPIX, C.COPY_WCS,
            C.RES_COPY_METADATA, C.RES_FILE_SIZE_BYTES, C.RES_DIMENSIONS}


@pytest.mark.parametrize("shapes", [((80, 96),) * 3,
                                    ((80, 96), (80, 96), (40, 48)),
                                    ((60, 96), (80, 70), (80, 96))],
                         ids=["same", "half_b", "mixed"])
@pytest.mark.parametrize("bitpix", [-32, 16])
def test_export_fits_rgb_from_files_matches_jax(tmp_path, rng, shapes,
                                                bitpix):
    paths = [_fits(str(tmp_path / f"{c}.fits"), _plane(rng, *s, bad=False),
                   CARDS if c == "r" else [("FILTER", f"'{c}'")])
             for c, s in zip("rgb", shapes)]
    a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    got = tapi.export_fits_rgb(a, *paths, bitpix=bitpix, device=CPU)
    want = japi.export_fits_rgb(b, *paths, bitpix=bitpix)
    got[C.RES_OUTPUT_PATH] = b
    _same_response(got, want, RGB_KEYS)
    assert got[C.RES_DIMENSIONS] == [96, 80]
    ta, tb = try_extract_rgb(a), try_extract_rgb(b)
    if len(set(shapes)) == 1:
        assert open(a, "rb").read() == open(b, "rb").read()
        return
    hdr = extract_image(b).header
    quantum = float(hdr.get_f64("BSCALE")) if bitpix == 16 else 0.0
    for x, y in ((ta.r, tb.r), (ta.g, tb.g), (ta.b, tb.b)):
        ulp = np.spacing(np.float32(np.abs(y).max()))
        np.testing.assert_allclose(x, y, atol=quantum + 2 * ulp, rtol=0)


def _seed_composites(rng, h=64, w=72):
    planes = [_plane(rng, h, w, bad=False) * s for s in (1.0, 0.7, 0.4)]
    tst = [compute_image_stats(torch.from_numpy(p)) for p in planes]
    thelpers.insert_composite_and_orig(*(torch.from_numpy(p)
                                         for p in planes), *tst)
    jp = [jnp.asarray(p) for p in planes]
    jhelpers.insert_composite_and_orig(*jp, *(jstats(p) for p in jp))
    return planes


def test_export_fits_rgb_from_the_composite_cache(tmp_path, rng):
    planes = _seed_composites(rng)
    p = _fits(str(tmp_path / "hdr.fits"), _plane(rng, 16, 16))
    for r_path in (p, "__composite_r", None):
        a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
        got = tapi.export_fits_rgb(a, r_path, device=CPU)
        want = japi.export_fits_rgb(b, r_path)
        got[C.RES_OUTPUT_PATH] = b
        _same_response(got, want, RGB_KEYS)
        assert open(a, "rb").read() == open(b, "rb").read()
        rgb = try_extract_rgb(a)
        np.testing.assert_array_equal(rgb.g, planes[1])
        assert (extract_image(a).header.get("OBJECT") == "M 42") == \
            (r_path == p)


def test_export_fits_rgb_needs_paths_without_a_composite(tmp_path):
    with pytest.raises(ValueError, match="R/G/B channel paths required"):
        tapi.export_fits_rgb(str(tmp_path / "t.fits"), "a.fits",
                             device=CPU)


PNG_KEYS = {C.RES_OUTPUT_PATH, C.RES_BIT_DEPTH, C.RES_APPLY_STF,
            C.RES_FILE_SIZE_BYTES, C.RES_DIMENSIONS}


def _png_close(got, want, depth, stf):
    """Equal without the STF; with it within one 8-bit level (2^8 at 16
    bits) where JAX's FMA moves the stretched f32 value (C13)."""
    if not stf:
        np.testing.assert_array_equal(got, want)
        return
    step = 1 if depth == 8 else 256
    d = np.abs(got - want)
    assert int(d.max()) <= step and (d > 0).mean() < 0.01


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("stf", [False, True])
def test_export_png_mono_matches_jax(tmp_path, rng, depth, stf):
    p = _fits(str(tmp_path / "in.fits"), _plane(rng))
    kw = dict(bit_depth=depth, apply_stf_stretch=stf,
              shadow=0.02 if stf else None, midtone=0.3 if stf else None)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    got = tapi.export_png(p, a, **kw, device=CPU)
    want = japi.export_png(p, b, **kw)
    keys = PNG_KEYS - {C.RES_FILE_SIZE_BYTES}   # Pillow's filters differ
    got[C.RES_OUTPUT_PATH] = b
    assert set(got) == set(want)
    for k in keys:
        assert got[k] == want[k], k
    px, depth_got, colour = _decode_png(a)
    assert (depth_got, colour) == (depth, 0)
    _png_close(px.astype(np.int64), _png_pixels(b), depth, stf)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("stf", [False, True])
def test_export_png_rgb_file_matches_jax(tmp_path, rng, depth, stf):
    planes = [_plane(rng, bad=False) * s for s in (1.0, 0.6, 0.3)]
    p = str(tmp_path / "rgb.fits")
    write_fits_rgb(p, *planes, HduHeader(CARDS))
    kw = dict(bit_depth=depth, apply_stf_stretch=stf,
              shadow=0.01 if stf else None, midtone=0.25 if stf else None)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    got = tapi.export_png(p, a, **kw, device=CPU)
    want = japi.export_png(p, b, **kw)
    got[C.RES_OUTPUT_PATH] = b
    assert set(got) == set(want)
    for k in PNG_KEYS - {C.RES_FILE_SIZE_BYTES}:
        assert got[k] == want[k], k
    assert got[C.RES_APPLY_STF] is True
    px, depth_got, colour = _decode_png(a)
    assert (depth_got, colour, px.shape) == (depth, 2, (80, 96, 3))
    if stf:
        _png_close(px.astype(np.int64), _png_pixels(b), depth, True)
        return
    # the linked auto-STF: from the port's own stats, exactly; and,
    # given JAX's stats (their median and MAD differ within C5), JAX's
    # pixels within the C13 tolerance
    conv = tex._to_u16 if depth == 16 else tex._to_u8
    t_planes = [torch.from_numpy(q) for q in planes]

    def stretched(stats):
        linked = thelpers.compute_linked_stf(*stats)
        return np.stack([conv(apply_stf_f32(q, linked, st).numpy())
                         for q, st in zip(t_planes, stats)], -1)

    np.testing.assert_array_equal(
        px, stretched([compute_image_stats(q) for q in t_planes]))
    j_stats = [ImageStats(**{k: getattr(jstats(jnp.asarray(q)), k) for k in (
        "min", "max", "median", "mad", "sigma", "mean", "valid_count")})
        for q in planes]
    _png_close(stretched(j_stats).astype(np.int64), _png_pixels(b), depth,
               True)


@pytest.mark.parametrize("depth", [8, 16, None])
def test_export_rgb_png_matches_jax(tmp_path, rng, depth):
    _seed_composites(rng)
    prm = dict(shadow_r=0.01, midtone_r=0.3, highlight_r=0.95,
               shadow_g=0.02, midtone_g=0.4, shadow_b=0.0, midtone_b=0.2,
               highlight_b=0.9)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    got = tapi.export_rgb_png(a, depth, **prm, device=CPU)
    want = japi.export_rgb_png(b, depth, **prm)
    got[C.RES_OUTPUT_PATH] = b
    keys = {C.RES_OUTPUT_PATH, C.RES_BIT_DEPTH, C.RES_DIMENSIONS}
    assert set(got) == set(want)
    for k in keys:
        assert got[k] == want[k], k
    px, depth_got, colour = _decode_png(a)
    assert (depth_got, colour, px.shape) == (depth or 16, 2, (64, 72, 3))
    _png_close(px.astype(np.int64), _png_pixels(b), depth or 16, True)


def test_export_rgb_png_needs_the_composite(tmp_path):
    from astroburst_tpu_torch.errors import CacheMiss
    with pytest.raises(CacheMiss):
        tapi.export_rgb_png(str(tmp_path / "t.png"), device=CPU)


def test_export_zip_bundle_matches_jax(tmp_path):
    p1 = tmp_path / "m16_ha.png"
    p1.write_bytes(b"\x89PNG fake")
    p2 = tmp_path / "m16_oiii.fits"
    p2.write_bytes(b"SIMPLE")
    p3 = tmp_path / "sub"
    p3.mkdir()
    (p3 / "m16_ha.png").write_bytes(b"second")
    files = [str(p1), str(p2), str(tmp_path / "missing.png"),
             str(p3 / "m16_ha.png")]
    pcts, jpcts = [], []
    got = tapi.export_zip_bundle(files, str(tmp_path / "t.zip"),
                                 progress_cb=pcts.append, device=CPU)
    want = japi.export_zip_bundle(files, str(tmp_path / "j.zip"),
                                  progress_cb=jpcts.append)
    assert got[C.RES_PATH] == str(tmp_path / "t.zip")
    for k in ("files", "skipped"):
        assert got[k] == want[k]
    assert got["files"] == ["m16_ha.png", "m16_oiii.png", "m16_ha_1.png"]
    assert pcts == jpcts and pcts[-1] == 100
    with zipfile.ZipFile(tmp_path / "t.zip") as zf:
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in zf.infolist())
        assert zf.read("m16_ha_1.png") == b"second"


def _no_card_calls(tmp_path, rng):
    """One call of each command of this slice, with valid inputs."""
    p = _fits(str(tmp_path / "in.fits"), _plane(rng, 24, 24))
    out = str(tmp_path / "out")
    return {
        "calibrate": lambda: tapi.calibrate(p, out, bias_paths=[p]),
        "run_pipeline_cmd": lambda: tapi.run_pipeline_cmd(
            [{"label": "L", "lights": [p, p, p]}], out),
        "drizzle_stack_cmd": lambda: tapi.drizzle_stack_cmd([p, p], out),
        "export_fits": lambda: tapi.export_fits(p, out + ".fits"),
        "export_fits_rgb": lambda: tapi.export_fits_rgb(
            out + ".fits", p, p, p),
        "export_png": lambda: tapi.export_png(p, out + ".png"),
        "export_rgb_png": lambda: tapi.export_rgb_png(out + ".png"),
        "resample_fits_cmd": lambda: tapi.resample_fits_cmd(p, out, 12, 12),
        "export_zip_bundle": lambda: tapi.export_zip_bundle(
            [p], out + ".zip"),
    }


@pytest.mark.parametrize("cmd", ["calibrate", "run_pipeline_cmd",
                                 "drizzle_stack_cmd", "export_fits",
                                 "export_fits_rgb", "export_png",
                                 "export_rgb_png", "resample_fits_cmd",
                                 "export_zip_bundle"])
def test_command_without_a_card_raises(tmp_path, rng, monkeypatch, cmd):
    """With no device named and no card, each command raises before any
    work: export_fits's fallback read and export_fits_rgb's header
    fallback do not turn the missing card into a host run, and a
    seeded composite does not either."""
    calls = _no_card_calls(tmp_path, rng)
    _seed_composites(rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        calls[cmd]()
    assert not os.path.exists(str(tmp_path / "out"))
    assert [f for f in os.listdir(tmp_path) if f.startswith("out")] == []
