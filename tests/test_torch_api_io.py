"""PyTorch port: the open-and-inspect commands against ``astroburst_tpu.api``
on the same files, written here from seeded numpy data (≤ 256², except
one histogram of 4097² pixels).

- ``process_fits`` / ``process_fits_full`` on mono, RGB, BITPIX 16 with
  BSCALE/BZERO, a multi-extension file, NaN/inf/padding pixels and a
  ZIP: the RES_* keys; stats as tests/test_torch_api_stacking.py holds
  them (min and max exact, mean rtol 1e-6, median and MAD within
  2·range/8**6: C5); STF parameters within 1e-4; PNGs within one grey
  level of JAX's, and bit-equal when the port is given JAX's stats; the
  RGB file's six composite keys, ORIG and KEY one tensor;
- histograms: bit-equal to a numpy oracle that counts below each edge
  over separately rounded f32 edges; against JAX the totals equal and a
  count differs only by pixels within one f32 ulp of an edge (XLA on
  the CPU may contract dmin + step·j to an FMA, as in ROADMAP C13); past
  2**24 valid pixels against the oracle only (C15);
- the raw preview: bytes equal to JAX's;
- ``apply_stf_render``: PNG bit-equal with the same parameters;
- header, extension, filter and output-dir commands: dicts equal
  (``elapsed_ms`` aside);
- every command has the JAX signature plus a keyword-only ``device``
  and, without one, raises where there is no card.
"""

import dataclasses
import inspect
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu import api as japi
from astroburst_tpu.api import helpers as jhelpers
from astroburst_tpu.dtypes import Histogram as JHistogram
from astroburst_tpu.ops.ipc import decode_binary_pixels as jdecode
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as JCACHE
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.errors import FitsError
from astroburst_tpu_torch.imaging.stf import auto_stf
from astroburst_tpu_torch.io import write_fits_mono, write_fits_rgb
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops import stats as tstats
from astroburst_tpu_torch.ops.ipc import decode_binary_pixels
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_io import _card, _decode_png, _hdu, _header_block

torch.set_num_threads(1)

CPU = torch.device("cpu")
C5 = 8.0 ** -6


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _field(rng, shape=(120, 200)):
    x = rng.normal(100.0, 5.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.02] = np.nan
    return x


def _inputs(root, rng, kind):
    """(path, the planes the file holds as f32) for one input kind."""
    os.makedirs(root, exist_ok=True)
    p = os.path.join(root, f"{kind}_field.fits")
    hdr = HduHeader([("OBJECT", "'M 16'"), ("FILTER", "'Ha 656nm'"),
                     ("EXPTIME", "300.0")])
    if kind == "mono":
        x = _field(rng)
        write_fits_mono(p, x, hdr)
        return p, [x]
    if kind == "nan":
        x = _field(rng, (96, 130))
        x[10:30, 40:70] = np.nan
        x[50, :20] = np.inf
        x[51, 3] = -np.inf
        x[:, -6:] = 0.0              # padding: invalid, but finite
        write_fits_mono(p, x, hdr)
        return p, [x]
    if kind == "bitpix16":
        raw = rng.integers(-3000, 3000, (80, 110))
        with open(p, "wb") as f:
            f.write(_hdu(raw, 16, [("FILTER", "'OIII'")], bscale=0.37,
                         bzero=32768.0))
        return p, [(raw * 0.37 + 32768.0).astype(np.float32)]
    if kind == "mef":
        prim = _header_block([_card("SIMPLE", "T"), _card("BITPIX", "8"),
                              _card("NAXIS", "0"),
                              _card("TELESCOP", "'JWST'"),
                              _card("FILTER", "'F444W'")])
        err = _hdu(_field(rng, (9, 11)), -32, [("EXTNAME", "'ERR'")],
                   primary=False)
        sci = _field(rng, (64, 90))
        with open(p, "wb") as f:
            f.write(prim + err + _hdu(sci, -32, [("EXTNAME", "'SCI'"),
                                                 ("EXPTIME", "99.0")],
                                      primary=False))
        return p, [sci]
    if kind == "rgb":
        r = _field(rng, (70, 90))
        planes = [r, r * 0.5 + 10.0, r * 0.25 + 30.0]
        write_fits_rgb(p, *planes, hdr)
        return p, planes
    assert kind == "zip"
    x = _field(rng, (60, 84))
    write_fits_mono(p, x, hdr)
    z = os.path.join(root, "zip_field.zip")
    with zipfile.ZipFile(z, "w") as zf:
        zf.write(p, "inner/zip_field.fits")
    os.remove(p)
    return z, [x]


def _port_stats(j) -> ImageStats:
    return ImageStats(**dataclasses.asdict(j))


def _assert_stats_close(got: dict, want: dict):
    assert set(got) == set(want)
    assert (got[C.RES_MIN], got[C.RES_MAX]) == (want[C.RES_MIN],
                                                want[C.RES_MAX])
    assert got[C.RES_MEAN] == pytest.approx(want[C.RES_MEAN], rel=1e-6)
    tol = 2 * (want[C.RES_MAX] - want[C.RES_MIN]) * C5
    for k in (C.RES_MEDIAN, C.RES_MAD):
        if k in want:
            assert abs(got[k] - want[k]) <= tol, k
    assert abs(got[C.RES_SIGMA] - want[C.RES_SIGMA]) <= tol * 1.4826


def _assert_stf_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


def _f32_edges(dmin, dmax, bins):
    lo = np.float32(dmin)
    step = (np.float32(dmax) - lo) / np.float32(bins)
    return lo + step * np.arange(1, bins, dtype=np.float32)


def _valid(x):
    x = np.asarray(x, np.float32).reshape(-1)
    return x[np.isfinite(x) & (x > 1e-7)]


def _oracle_counts(x, dmin, dmax, bins):
    """int64 counts from the count below each f32 edge of the sorted
    valid values (the cumulative form, not the port's search)."""
    v = np.sort(_valid(x))
    below = np.searchsorted(v, _f32_edges(dmin, dmax, bins), side="left")
    return np.diff(np.concatenate([[0], below, [v.size]])).astype(np.int64)


def _assert_hist_vs_jax(got, want, x, dmin, dmax):
    """Totals equal; each count off only by pixels within one f32 ulp of
    one of the bin's two edges."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.sum() == want.sum() == _valid(x).size
    edges = _f32_edges(dmin, dmax, got.size)
    v = _valid(x)
    near = np.array([int((np.abs(v - e) <= np.spacing(e)).sum())
                     for e in edges])
    allowed = np.concatenate([[0], near]) + np.concatenate([near, [0]])
    assert (np.abs(got - want) <= allowed).all(), \
        np.nonzero(got != want)[0]


def _png_pixels(path):
    return _decode_png(path)[0]


def _strip(d):
    d = dict(d)
    d.pop(C.RES_ELAPSED_MS)
    return d


KINDS = ["mono", "nan", "bitpix16", "mef", "rgb", "zip"]


@pytest.mark.parametrize("full", [False, True],
                         ids=["process_fits", "process_fits_full"])
@pytest.mark.parametrize("kind", KINDS)
def test_process_fits_matches_jax(tmp_path, rng, kind, full):
    path, planes = _inputs(str(tmp_path / "in"), rng, kind)
    cmd = "process_fits_full" if full else "process_fits"
    got = getattr(tapi, cmd)(path, str(tmp_path / "t"), device=CPU)
    want = getattr(japi, cmd)(path, str(tmp_path / "j"))
    assert set(got) == set(want)
    assert got[C.RES_DIMENSIONS] == want[C.RES_DIMENSIONS] == \
        [planes[0].shape[1], planes[0].shape[0]]
    _assert_stats_close(got[C.RES_STATS], want[C.RES_STATS])
    _assert_stf_close(got[C.RES_STF], want[C.RES_STF])
    png, j_png = _png_pixels(got[C.RES_PNG_PATH]), \
        np.asarray(Image.open(want[C.RES_PNG_PATH]))
    assert png.shape == j_png.shape
    assert int(np.abs(png.astype(int) - j_png).max()) <= 1

    again = str(tmp_path / "again.png")
    if kind == "rgb":
        assert got["is_rgb"] is want["is_rgb"] is True
        for key in (C.STF_R, C.STF_G, C.STF_B):
            _assert_stf_close(got[key], want[key])
        j_st = [_port_stats(JCACHE.get(k).stats) for k in (
            C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B)]
        thelpers.render_rgb_preview_with_stf(
            *(torch.from_numpy(p) for p in planes),
            *(auto_stf(s) for s in j_st), *j_st, again)
        # the six composite keys, ORIG and KEY one tensor
        for orig, key, plane in zip(
                (C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B),
                (C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B),
                planes):
            eo, ek = GLOBAL_IMAGE_CACHE.get(orig), GLOBAL_IMAGE_CACHE.get(key)
            assert eo.image is ek.image and eo.stats is ek.stats
            np.testing.assert_array_equal(eo.image.numpy(), plane)
            _assert_stats_close(thelpers.stats_json_full(eo.stats),
                                jhelpers.stats_json_full(
                                    JCACHE.get(orig).stats))
    else:
        j_st = _port_stats(JCACHE.get(path).stats)
        thelpers.save_stf_preview_png(torch.from_numpy(planes[0]),
                                      auto_stf(j_st), j_st, again)
        entry = GLOBAL_IMAGE_CACHE.get(path, CPU)
        np.testing.assert_array_equal(entry.image.numpy(), planes[0])
    np.testing.assert_array_equal(_png_pixels(again), j_png)

    if full:
        assert got[C.RES_HEADER] == want[C.RES_HEADER]
        h, jh = got[C.RES_HISTOGRAM], want[C.RES_HISTOGRAM]
        assert set(h) == set(jh)
        for k in (C.RES_BIN_COUNT, C.RES_DATA_MIN, C.RES_DATA_MAX,
                  C.RES_TOTAL_PIXELS):
            assert h[k] == jh[k], k
        _assert_stf_close(h[C.RES_AUTO_STF], jh[C.RES_AUTO_STF])
        lo, hi = h[C.RES_DATA_MIN], h[C.RES_DATA_MAX]
        np.testing.assert_array_equal(
            h[C.RES_BINS], _oracle_counts(planes[0], lo, hi, 512))
        _assert_hist_vs_jax(h[C.RES_BINS], jh[C.RES_BINS], planes[0], lo, hi)

    # warm: the cache answers with the same response
    warm = getattr(tapi, cmd)(path, str(tmp_path / "t"), device=CPU)
    assert _strip(warm) == _strip(got)


@pytest.mark.parametrize("bins", [None, 1, 7, 100])
@pytest.mark.parametrize("kind", ["mono", "bitpix16", "nan"])
def test_compute_histogram_matches_oracle_and_jax(tmp_path, rng, kind, bins):
    path, planes = _inputs(str(tmp_path / "in"), rng, kind)
    got = tapi.compute_histogram(path, bins, device=CPU)
    want = japi.compute_histogram(path, bins)
    assert set(got) == set(want)
    for k in (C.RES_BIN_COUNT, C.RES_BIN_EDGES, C.RES_DATA_MIN,
              C.RES_DATA_MAX):
        assert got[k] == want[k], k
    lo, hi, n = got[C.RES_DATA_MIN], got[C.RES_DATA_MAX], got[C.RES_BIN_COUNT]
    assert n == (bins or 512)
    np.testing.assert_array_equal(got[C.RES_BINS],
                                  _oracle_counts(planes[0], lo, hi, n))
    _assert_hist_vs_jax(got[C.RES_BINS], want[C.RES_BINS], planes[0], lo, hi)
    assert tapi.compute_histogram_cmd(path, bins, device=CPU)[C.RES_BINS] \
        == got[C.RES_BINS]


def test_histogram_on_edges_outside_the_range_and_empty(rng):
    """Values on the edges, below dmin (bin 0) and above dmax (the last
    bin), against the oracle and JAX's compute_histogram; an empty or
    flat plane gives zeros."""
    from astroburst_tpu.ops import stats as jstats
    import jax.numpy as jnp
    x = (rng.integers(0, 400, (90, 110)) * 0.25 + 1.0).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    for dmin, dmax, bins in ((1.0, 100.75, 399), (10.0, 50.0, 160),
                             (1.0, 100.75, 3), (-5.0, 200.0, 64)):
        got = tstats.compute_histogram(torch.from_numpy(x), bins, dmin, dmax)
        want = jstats.compute_histogram(jnp.asarray(x), bins, dmin, dmax)
        assert got.bin_edges == want.bin_edges and got.min == want.min
        np.testing.assert_array_equal(got.bins,
                                      _oracle_counts(x, dmin, dmax, bins))
        _assert_hist_vs_jax(got.bins, want.bins, x, dmin, dmax)
    below = _valid(x) < _f32_edges(10.0, 50.0, 160)[0]
    assert tstats.compute_histogram(torch.from_numpy(x), 160, 10.0,
                                    50.0).bins[0] == int(below.sum())
    for plane in (np.full((5, 7), np.nan, np.float32),
                  np.full((5, 7), 3.0, np.float32)):
        got = tstats.compute_histogram(torch.from_numpy(plane), 8)
        want = jstats.compute_histogram(jnp.asarray(plane), 8)
        assert got.to_dict() == want.to_dict()
    h = tstats.compute_histogram(torch.from_numpy(x), 512)
    assert tstats.downsample_histogram(h, 100) == \
        jstats.downsample_histogram(JHistogram(**dataclasses.asdict(h)), 100)


def test_histogram_past_2_24_valid_pixels_matches_the_oracle(rng):
    """4097² pixels, 100 of them NaN: 16 785 309 valid, past 2**24 where
    f32 counts stop being exact (C15); against the numpy oracle only."""
    x = rng.normal(0.5, 0.1, (4097, 4097)).astype(np.float32)
    x[rng.integers(0, 4097, 100), rng.integers(0, 4097, 100)] = np.nan
    n_valid = _valid(x).size
    assert n_valid > 2 ** 24
    got = tstats.compute_histogram(torch.from_numpy(x), 512)
    assert sum(got.bins) == n_valid
    np.testing.assert_array_equal(got.bins,
                                  _oracle_counts(x, got.min, got.max, 512))


@pytest.mark.parametrize("max_dim", [None, 100, 33])
@pytest.mark.parametrize("kind", ["mono", "nan", "mef"])
def test_raw_preview_bytes_equal_jax(tmp_path, rng, kind, max_dim):
    path, planes = _inputs(str(tmp_path / "in"), rng, kind)
    cold = tapi.get_raw_pixels_preview(path, max_dim, device=CPU)
    want = japi.get_raw_pixels_preview(path, max_dim)
    assert bytes(cold) == bytes(want)
    arr, mn, mx = decode_binary_pixels(cold)
    np.testing.assert_array_equal(arr, jdecode(bytes(want))[0])
    finite = np.isfinite(planes[0])
    if max_dim is None:
        np.testing.assert_array_equal(
            arr, np.where(finite, planes[0], 0.0).astype(np.float32))
        assert (mn, mx) == (planes[0][finite].min(), planes[0][finite].max())
    # from the cache (process_fits left the plane there)
    tapi.process_fits(path, str(tmp_path / "t"), device=CPU)
    assert bytes(tapi.get_raw_pixels_preview(path, max_dim,
                                             device=CPU)) == bytes(want)


def test_raw_preview_of_a_plane_without_finite_pixels(tmp_path):
    p = str(tmp_path / "nan.fits")
    x = np.full((20, 30), np.nan, np.float32)
    x[3, 4] = np.inf
    write_fits_mono(p, x)
    got = tapi.get_raw_pixels_preview(p, device=CPU)
    assert bytes(got) == bytes(japi.get_raw_pixels_preview(p))
    arr, mn, mx = decode_binary_pixels(got)
    assert (mn, mx) == (0.0, 0.0) and not arr.any()


def _stf_u8_oracle(x, params, dmin, dmax):
    """numpy f32, every operation rounded: (the u8 STF of x, its
    clipped normalised value c) (imaging/stf.py's _stf_core and
    _finish)."""
    f = np.float32
    shadow, m, highlight = params
    rng_ = max(dmax - dmin, 1e-30)
    clip = max(highlight - shadow, 1e-15)
    lo, inv_r, sh, inv_c, m = (f(v) for v in (dmin, 1.0 / rng_, shadow,
                                              1.0 / clip, m))
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.clip(((x - lo) * inv_r - sh) * inv_c, f(0), f(1))
        s = (m - f(1)) * c / ((f(2) * m - f(1)) * c - m)
        out = np.where(c <= 0, f(0), np.where(c >= 1, f(1), s))
        q = np.clip(np.round(out * f(255)), 0, 255)
    return np.where(np.isfinite(x) & (x > 1e-7), q, 0).astype(np.uint8), c


@pytest.mark.parametrize("params", [(0.0, 0.5, 1.0), (0.1, 0.3, 1.0),
                                    (0.02, 0.07, 0.9), (0.98, 0.9999, 1.0)])
@pytest.mark.parametrize("kind", ["mono", "nan"])
def test_apply_stf_render_bit_equal(tmp_path, rng, kind, params):
    """Bit-equal to JAX's PNG and to the numpy oracle. At midtone 0.9999
    the MTF's denominator (2m - 1)·c - m cancels to ~1e-4 near c = 1,
    where ds/dc ~ 1e4: the f32 roundings that XLA on the CPU saves by
    contracting to FMAs (ROADMAP C13) move such pixels by a few levels.
    There JAX is held equal wherever c < 0.99, the port to the oracle
    bit for bit everywhere."""
    path, planes = _inputs(str(tmp_path / "in"), rng, kind)
    got = tapi.apply_stf_render(path, str(tmp_path / "t"), *params,
                                device=CPU)
    want = japi.apply_stf_render(path, str(tmp_path / "j"), *params)
    assert set(got) == set(want)
    assert got[C.RES_STF] == want[C.RES_STF]
    assert got[C.RES_DIMENSIONS] == want[C.RES_DIMENSIONS]
    assert os.path.basename(got[C.RES_PNG_PATH]) == \
        os.path.basename(want[C.RES_PNG_PATH])
    png = _png_pixels(got[C.RES_PNG_PATH])
    j_png = np.asarray(Image.open(want[C.RES_PNG_PATH]))
    st = GLOBAL_IMAGE_CACHE.get(path, CPU).stats
    oracle, c = _stf_u8_oracle(planes[0], params, st.min, st.max)
    np.testing.assert_array_equal(png, oracle)
    if params[1] < 0.999:
        np.testing.assert_array_equal(png, j_png)
    else:
        assert (c[png != j_png] >= 0.99).all()


def test_apply_stf_render_of_a_composite_key(tmp_path, rng):
    path, planes = _inputs(str(tmp_path / "in"), rng, "rgb")
    tapi.process_fits(path, str(tmp_path / "t"), device=CPU)
    japi.process_fits(path, str(tmp_path / "j"))
    for key in (C.COMPOSITE_KEY_G, C.COMPOSITE_ORIG_B):
        got = tapi.apply_stf_render(key, str(tmp_path / "t"), 0.05, 0.2,
                                    1.0, device=CPU)
        want = japi.apply_stf_render(key, str(tmp_path / "j"), 0.05, 0.2,
                                     1.0)
        np.testing.assert_array_equal(
            _png_pixels(got[C.RES_PNG_PATH]),
            np.asarray(Image.open(want[C.RES_PNG_PATH])))
    from astroburst_tpu_torch.errors import CacheMiss
    with pytest.raises(CacheMiss):
        tapi.apply_stf_render("__composite_x", str(tmp_path / "t"), 0.0,
                              0.5, 1.0, device=CPU)


@pytest.mark.parametrize("kind", ["mono", "mef", "zip", "bitpix16", "rgb"])
def test_header_commands_match_jax(tmp_path, rng, kind):
    path, _ = _inputs(str(tmp_path / "in"), rng, kind)
    for cmd in ("get_header", "get_full_header"):
        got = getattr(tapi, cmd)(path, device=CPU)
        assert _strip(got) == _strip(getattr(japi, cmd)(path)), cmd
    if kind in ("zip", "rgb"):
        return
    got = tapi.get_fits_extensions(path, device=CPU)
    assert _strip(got) == _strip(japi.get_fits_extensions(path))
    for i in range(got["extension_count"]):
        if kind == "mef" and i == 0:
            with pytest.raises(FitsError, match="no image data"):
                tapi.get_header_by_hdu(path, i, device=CPU)
            continue
        assert _strip(tapi.get_header_by_hdu(path, i, device=CPU)) == \
            _strip(japi.get_header_by_hdu(path, i))
    with pytest.raises(FitsError, match="out of range"):
        tapi.get_header_by_hdu(path, 7, device=CPU)


def test_get_header_reads_the_cached_header(tmp_path, rng):
    path, planes = _inputs(str(tmp_path / "in"), rng, "mono")
    got = tapi.get_header(path, device=CPU)
    entry = GLOBAL_IMAGE_CACHE.get(path, CPU)     # loaded as JAX loads it
    np.testing.assert_array_equal(entry.image.numpy(), planes[0])
    assert got[C.RES_HEADER] == dict(entry.header.index)
    assert got[C.RES_HEADER]["OBJECT"] == "M 16"


@pytest.mark.parametrize("palette", [None, "HOO", "hubble", "Custom",
                                     "natural color"])
def test_detect_narrowband_filters_matches_jax(tmp_path, rng, palette):
    root = tmp_path / "nb"
    root.mkdir()
    paths = []
    for name, cards in (("m16_Ha.fits", [("FILTER", "'H-alpha'")]),
                        ("m16_b.fits", [("INSTRUME", "'OIII filter'")]),
                        ("m16_SII.fits", []),
                        ("m16_c.fits", [("WAVELEN", "6730.0")]),
                        ("m16_d.fits", [("BANDPASS", "'[OIII] 502nm'")])):
        paths.append(str(root / name))
        write_fits_mono(paths[-1], _field(rng, (8, 9)), HduHeader(cards))
    paths.append(str(root / "missing_O3.fits"))
    got = tapi.detect_narrowband_filters(paths, palette, device=CPU)
    want = japi.detect_narrowband_filters(paths, palette)
    assert _strip(got) == _strip(want)


def test_output_dir_commands_match_jax(tmp_path, monkeypatch):
    def tree(root):
        os.makedirs(os.path.join(root, "sub"))
        for k, (name, size) in enumerate((("a.png", 500), ("b.fits", 3000),
                                          ("sub/c.png", 1200),
                                          ("d.png", 800))):
            p = os.path.join(root, name)
            with open(p, "wb") as f:
                f.write(b"x" * size)
            os.utime(p, (1_000_000 + k, 1_000_000 + k))

    def files(root):
        return sorted(os.path.relpath(os.path.join(r, n), root)
                      for r, _, ns in os.walk(root) for n in ns)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tree(a)
    tree(b)
    assert tapi.get_output_dir_info(a, device=CPU) == \
        japi.get_output_dir_info(a)
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "config.json").write_text(json.dumps({"output_max_bytes": 2500}))
    monkeypatch.setenv("ASTROBURST_CONFIG_DIR", str(cfg))
    got = tapi.cleanup_output_cmd(a, True, device=CPU)
    assert got == japi.cleanup_output_cmd(b, True) == \
        {"cleaned_bytes": 3500, "cleaned_files": 2}
    assert files(a) == files(b) == ["d.png", "sub/c.png"]
    assert tapi.cleanup_output_cmd(a, device=CPU) == \
        japi.cleanup_output_cmd(b)
    assert files(a) == files(b) == []


def test_commands_have_the_jax_signature_plus_device():
    names = set(tapi.__all__)
    assert names == {"process_fits", "process_fits_full",
                     "get_raw_pixels_preview", "apply_stf_render",
                     "compute_histogram", "compute_histogram_cmd",
                     "get_header", "get_full_header", "get_fits_extensions",
                     "get_header_by_hdu", "detect_narrowband_filters",
                     "get_output_dir_info", "cleanup_output_cmd", "stack",
                     "calibrate", "run_pipeline_cmd", "drizzle_stack_cmd",
                     "export_fits", "export_fits_rgb", "export_png",
                     "export_rgb_png", "resample_fits_cmd",
                     "export_zip_bundle", "wavelet_denoise_cmd",
                     "apply_arcsinh_stretch_cmd", "masked_stretch_cmd",
                     "arcsinh_stretch_composite_cmd",
                     "masked_stretch_composite_cmd",
                     "apply_tone_composite_cmd", "extract_background_cmd",
                     "detect_stars", "detect_stars_composite",
                     "analyze_subframes_cmd", "estimate_psf_cmd",
                     "compose_rgb_cmd", "restretch_composite_cmd",
                     "clear_composite_cache_cmd",
                     "update_composite_channel_cmd", "blend_channels_cmd",
                     "align_channels_cmd", "crop_channels_cmd",
                     "export_aligned_channels_cmd", "calibrate_and_scnr_cmd",
                     "compute_auto_wb_cmd", "reset_wb_cmd",
                     "compute_fft_spectrum", "deconvolve_rl_cmd",
                     "process_cube_cmd", "process_cube_lazy_cmd",
                     "get_cube_info", "get_cube_frame", "get_cube_spectrum",
                     "generate_tiles", "generate_tiles_rgb",
                     "generate_synth_cmd", "generate_synth_stack_cmd"}
    assert tapi.compute_histogram is tapi.compute_histogram_cmd
    for name in names:
        got = inspect.signature(getattr(tapi, name)).parameters
        want = inspect.signature(getattr(japi, name)).parameters
        assert list(got)[:-1] == list(want), name
        for p, q in zip(list(got.values())[:-1], want.values()):
            assert (p.kind, p.default) == (q.kind, q.default), (name, p)
        dev = got["device"]
        assert (dev.kind, dev.default) == (inspect.Parameter.KEYWORD_ONLY,
                                           None), name


def test_commands_without_a_device_raise_where_there_is_no_card(tmp_path,
                                                                rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path, _ = _inputs(str(tmp_path / "in"), rng, "mono")
    out = str(tmp_path / "out")
    calls = [("process_fits", (path, out)), ("process_fits_full", (path, out)),
             ("get_raw_pixels_preview", (path,)),
             ("apply_stf_render", (path, out, 0.0, 0.5, 1.0)),
             ("compute_histogram", (path,)), ("get_header", (path,)),
             ("get_full_header", (path,)), ("get_fits_extensions", (path,)),
             ("get_header_by_hdu", (path, 0)),
             ("detect_narrowband_filters", ([path],)),
             ("get_output_dir_info", (out,)), ("cleanup_output_cmd", (out,)),
             ("stack", ([path], out)),
             ("calibrate", (path, out, [path])),
             ("run_pipeline_cmd", ([{"lights": [path]}], out)),
             ("drizzle_stack_cmd", ([path, path], out)),
             ("export_fits", (path, out + ".fits")),
             ("export_fits_rgb", (out + ".fits", path, path, path)),
             ("export_png", (path, out + ".png")),
             ("export_rgb_png", (out + ".png",)),
             ("resample_fits_cmd", (path, out, 8, 8)),
             ("export_zip_bundle", ([path], out + ".zip")),
             ("wavelet_denoise_cmd", (path, out)),
             ("apply_arcsinh_stretch_cmd", (path, out, 50.0)),
             ("masked_stretch_cmd", (path, out)),
             ("arcsinh_stretch_composite_cmd", (out, 30.0)),
             ("masked_stretch_composite_cmd", (out,)),
             ("apply_tone_composite_cmd", (out,)),
             ("extract_background_cmd", (path, out)),
             ("detect_stars", (path,)), ("detect_stars_composite", ()),
             ("analyze_subframes_cmd", ([path],)),
             ("estimate_psf_cmd", (path,)),
             ("compose_rgb_cmd", (out, None, path, path)),
             ("restretch_composite_cmd", (out, 0, .5, 1, 0, .5, 1, 0, .5,
                                          1)),
             ("clear_composite_cache_cmd", ()),
             ("update_composite_channel_cmd", ("r", path)),
             ("blend_channels_cmd", ([path], [], out)),
             ("align_channels_cmd", ([path, path], out)),
             ("crop_channels_cmd", ([path], out)),
             ("export_aligned_channels_cmd", ([path, path], out)),
             ("calibrate_and_scnr_cmd", (out, 1.0, 1.0, 1.0)),
             ("compute_auto_wb_cmd", ()), ("reset_wb_cmd", (out,)),
             ("compute_fft_spectrum", (path,)),
             ("deconvolve_rl_cmd", (path, out)),
             ("process_cube_cmd", (path, out)),
             ("process_cube_lazy_cmd", (path, out)),
             ("get_cube_info", (path,)), ("get_cube_frame", (path, 0, out)),
             ("get_cube_spectrum", (path, 0, 0)),
             ("generate_tiles", (path, out)), ("generate_tiles_rgb", (out,)),
             ("generate_synth_cmd", (out, 8, 8, 1)),
             ("generate_synth_stack_cmd", (out, 2, 8, 8, 1))]
    assert {n for n, _ in calls} | {"compute_histogram_cmd"} == \
        set(tapi.__all__)
    for name, args in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tapi, name)(*args)
    assert GLOBAL_IMAGE_CACHE.keys() == []


def test_helpers_match_jax(tmp_path, rng):
    """The helpers the compose commands will use: linked STF, the RGB
    preview of stretched planes, the brief stats, the composite path and
    the composite loaders."""
    from astroburst_tpu.dtypes import ImageStats as JStats
    from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as jcache
    from astroburst_tpu_torch.errors import CacheMiss
    sts = [dict(min=1.0 + k, max=900.0 - k, median=100.0 + k, mad=4.0 + k,
                sigma=(4.0 + k) * 1.4826, mean=120.0 + k, valid_count=99)
           for k in range(3)]
    got = thelpers.compute_linked_stf_with_stats(
        *(ImageStats(**d) for d in sts))
    want = jhelpers.compute_linked_stf_with_stats(*(JStats(**d) for d in sts))
    assert got[0].to_dict() == want[0].to_dict()
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert thelpers.compute_linked_stf(*(ImageStats(**d) for d in sts)) \
        .to_dict() == want[0].to_dict()
    assert thelpers.stats_brief(ImageStats(**sts[0])) == \
        jhelpers.stats_brief(JStats(**sts[0]))

    planes = [rng.random((40, 50)).astype(np.float32) * 1.2 - 0.1
              for _ in range(3)]
    planes[1][3, :5] = (np.nan, np.inf, -np.inf, 0.5 / 255, 1.5 / 255)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    thelpers.render_rgb_preview(*(torch.from_numpy(p) for p in planes), a,
                                max_dim=32)
    jhelpers.render_rgb_preview(*planes, b, max_dim=32)
    np.testing.assert_array_equal(_png_pixels(a), np.asarray(Image.open(b)))
    u8 = torch.from_numpy((planes[0] * 200).clip(0, 255).astype(np.uint8))
    thelpers.save_preview_png(u8, a, max_dim=20)
    jhelpers.save_preview_png(u8.numpy(), b, max_dim=20)
    np.testing.assert_array_equal(_png_pixels(a), np.asarray(Image.open(b)))

    for k in range(2):
        (tmp_path / f"rgb_composite_{k}.png").write_bytes(b"x")
    path = thelpers.composite_png_path(str(tmp_path))
    assert os.path.basename(path).startswith("rgb_composite_")
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith("rgb_composite")]

    with pytest.raises(CacheMiss):
        thelpers.load_orig_or_composite()
    r, g, b_ = (torch.from_numpy(p) for p in planes)
    st = [ImageStats(**d) for d in sts]
    thelpers.insert_composite_rgb(r, g, b_, *st)
    def same(entries, want):
        return all(e.image is w for e, w in zip(entries, want))

    assert same(thelpers.load_orig_or_composite(), (r, g, b_))
    with pytest.raises(CacheMiss):
        thelpers.load_composite_orig_rgb()
    thelpers.insert_composite_and_orig(g, b_, r, *st)
    assert same(thelpers.load_orig_or_composite(), (g, b_, r))
    assert same(thelpers.load_composite_rgb(), (g, b_, r))
    jcache.clear()


def test_load_many_from_cache_or_disk(tmp_path, rng):
    from astroburst_tpu_torch.api import common as tcommon
    from astroburst_tpu_torch.errors import CacheMiss
    path, planes = _inputs(str(tmp_path / "in"), rng, "mono")
    other, more = _inputs(str(tmp_path / "in2"), rng, "nan")
    key = C.COMPOSITE_KEY_R
    GLOBAL_IMAGE_CACHE.insert(key, torch.from_numpy(more[0]))
    got = tcommon.load_many_from_cache_or_disk([path, key, other, path],
                                               device=CPU)
    assert got[0] is got[3]
    for e, want in zip(got, (planes[0], more[0], more[0], planes[0])):
        np.testing.assert_array_equal(e.image.numpy(), want)
        assert e.stats is not None
    assert tcommon.load_from_cache_or_disk(key, CPU) is got[1]
    with pytest.raises(CacheMiss):
        tcommon.load_many_from_cache_or_disk([path, "__composite_g"],
                                             device=CPU)
    with pytest.raises(CacheMiss):
        tcommon.load_from_cache_or_disk("__nothing", CPU)
    entry = tcommon.load_cached_full(other, CPU)
    assert entry is GLOBAL_IMAGE_CACHE.get(other, CPU)
    assert entry.header.get("OBJECT") == "M 16"
