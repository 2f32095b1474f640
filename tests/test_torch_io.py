"""PyTorch port: the io and runtime modules of the ``stack`` command
against the JAX package, on files the tests write from seeded numpy data.

- FITS: the same header cards, the same pixels (BITPIX -32, 16 with
  BZERO/BSCALE, 32 and -64, NaN pixels, a multi-HDU file whose best HDU
  is not the first), and byte-equal files from both writers;
- PNG: the port's file (no Pillow) decodes, with zlib here, to the
  pixels of the JAX package's Pillow file;
- dispatcher, cache, progress: the same lists, keys and events (ASDF
  paths resolved as the JAX dispatcher resolves them);
- ``nearest_downsample``: the same index maps, including the one row
  of 5655 → 4096 that an f64 map would move;
- ``compute_image_stats``: within C5's range/8**6 of JAX's on both
  sides of 4 M pixels; ``auto_stf`` and ``apply_stf_u8`` bit-equal
  given the same ImageStats.
"""

import dataclasses
import os
import struct
import zipfile
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu import errors as je
from astroburst_tpu.dtypes import StfParams as JStf
from astroburst_tpu.imaging import stf as jstf
from astroburst_tpu.io import dispatcher as jdisp
from astroburst_tpu.io import fits_reader as jread
from astroburst_tpu.io import fits_writer as jwrite
from astroburst_tpu.io import png as jpng
from astroburst_tpu.io.header import HduHeader as JHeader
from astroburst_tpu.io.header import extract_header_value as jvalue
from astroburst_tpu.ops import ipc as jipc
from astroburst_tpu.ops import stats as jstats
from astroburst_tpu.runtime import cache as jcache
from astroburst_tpu.runtime import progress as jprog
from astroburst_tpu_torch import errors as te
from astroburst_tpu_torch.dtypes import ImageStats, StfParams
from astroburst_tpu_torch.imaging import stf as tstf
from astroburst_tpu_torch.io import dispatcher as tdisp
from astroburst_tpu_torch.io import fits_reader as tread
from astroburst_tpu_torch.io import fits_writer as twrite
from astroburst_tpu_torch.io import png as tpng
from astroburst_tpu_torch.io import prefetch as tpre
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.io.header import extract_header_value as tvalue
from astroburst_tpu_torch.ops import ipc as tipc
from astroburst_tpu_torch.ops import stats as tstats
from astroburst_tpu_torch.runtime import cache as tcache
from astroburst_tpu_torch.runtime import output as tout
from astroburst_tpu_torch.runtime import progress as tprog

torch.set_num_threads(1)

CPU = torch.device("cpu")
C5 = 8.0 ** -6   # JAX's compare-count median/MAD: within range/8**6


@pytest.fixture(autouse=True)
def _clear_port_cache():
    yield
    tcache.GLOBAL_IMAGE_CACHE.clear()


def _card(key, value):
    return f"{key:<8}= {value:>20}".ljust(80).encode()


def _header_block(cards):
    blob = b"".join(cards) + b"END".ljust(80)
    return blob + b" " * ((-len(blob)) % 2880)


def _hdu(data, bitpix, cards=(), bscale=None, bzero=None, primary=True):
    """One HDU's bytes, written here (independent of both writers)."""
    h, w = data.shape
    head = [_card("SIMPLE", "T") if primary else
            _card("XTENSION", "'IMAGE   '"),
            _card("BITPIX", str(bitpix)), _card("NAXIS", "2"),
            _card("NAXIS1", str(w)), _card("NAXIS2", str(h))]
    if bscale is not None:
        head.append(_card("BSCALE", repr(bscale)))
    if bzero is not None:
        head.append(_card("BZERO", repr(bzero)))
    head += [_card(k, v) for k, v in cards]
    dt = {16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    payload = np.asarray(data).astype(dt).tobytes()
    return _header_block(head) + payload + b"\0" * ((-len(payload)) % 2880)


CARDS = (("OBJECT", "'M 16 field'"), ("EXPTIME", "300.5 / seconds"),
         ("CRVAL1", "1.25D+02"), ("TELESCOP", "'JWST    '"),
         ("COMMENTX", "'a / b'"), ("EQUINOX", "2000"))


def _raw(bitpix, rng, shape=(37, 53)):
    if bitpix in (-32, -64):
        x = rng.normal(100.0, 30.0, shape)
        x[rng.random(shape) < 0.03] = np.nan
        x[0, :3] = (np.inf, -np.inf, -0.0)
        return x.astype(np.float32 if bitpix == -32 else np.float64)
    lo, hi = {16: (-32768, 32768), 32: (-2**31, 2**31)}[bitpix]
    x = rng.integers(lo, hi, shape, dtype=np.int64)
    x[0, :2] = (lo, hi - 1)
    return x


@pytest.mark.parametrize("bitpix,bscale,bzero", [
    (-32, None, None), (16, 0.37, 32768.0), (32, 2.5e-3, -7.0),
    (-64, None, None), (-32, 2.0, 1.5)])
def test_extract_image_matches_jax(tmp_path, rng, bitpix, bscale, bzero):
    p = str(tmp_path / "a.fits")
    with open(p, "wb") as f:
        f.write(_hdu(_raw(bitpix, rng), bitpix, CARDS, bscale, bzero))
    got, want = tread.extract_image(p), jread.extract_image(p)
    assert got.image.dtype == np.float32
    np.testing.assert_array_equal(got.image, want.image)   # NaN == NaN
    assert got.header.cards == want.header.cards
    assert got.header.get_f64("CRVAL1") == want.header.get_f64("CRVAL1")
    assert (got.is_mef, got.selected_extension, got.extension_count) == \
        (want.is_mef, want.selected_extension, want.extension_count)


def test_extract_image_multi_hdu_best_not_first(tmp_path, rng):
    """Primary without data, an ERR extension, then SCI: SCI wins and
    the header is the primary ⊕ extension merge."""
    prim = _header_block([_card("SIMPLE", "T"), _card("BITPIX", "8"),
                          _card("NAXIS", "0"), _card("TELESCOP", "'JWST'"),
                          _card("EXPTIME", "12.0")])
    err = _hdu(_raw(-32, rng, (9, 11)), -32, [("EXTNAME", "'ERR'")],
               primary=False)
    sci = _hdu(_raw(16, rng, (21, 17)), 16,
               [("EXTNAME", "'SCI'"), ("EXPTIME", "99.0")], bscale=1.5,
               bzero=32768.0, primary=False)
    p = str(tmp_path / "mef.fits")
    with open(p, "wb") as f:
        f.write(prim + err + sci)
    got, want = tread.extract_image(p), jread.extract_image(p)
    assert got.selected_extension == want.selected_extension == "SCI"
    assert got.extension_count == want.extension_count == 3
    np.testing.assert_array_equal(got.image, want.image)
    assert got.header.cards == want.header.cards
    assert got.header.get("EXPTIME") == "99.0"
    assert [i.to_dict() for i in got.extensions] == \
        [i.to_dict() for i in want.extensions]


def test_header_values_and_model_match_jax():
    for raw in ("'M 16 field'  / name", "  300.5 / seconds", "'a / b'",
                "'unterminated", "T", "", "  42  ", "'  '"):
        assert tvalue(raw) == jvalue(raw), raw
    t, j = HduHeader(list(CARDS)), JHeader(list(CARDS))
    for h in (t, j):
        h.set("NEW", "1")
        h.set_f64("CRVAL2", -3.5)
        h.remove("EQUINOX")
    assert t.cards == j.cards and t.to_dict() == j.to_dict()
    ext = [("EXPTIME", "1"), ("XTENSION", "'IMAGE'"), ("BUNIT", "'MJy'")]
    assert t.merge_with(HduHeader(ext)).cards == \
        j.merge_with(JHeader(ext)).cards
    assert t.get_i64("NEW") == j.get_i64("NEW") == 1
    assert t.get_f64("CRVAL1") == j.get_f64("CRVAL1") == 125.0
    assert t.get_i64("EXPTIME") is j.get_i64("EXPTIME") is None


def test_extract_image_into_a_given_buffer(tmp_path, rng):
    """``alloc`` receives the plane's shape and the pixels land in the
    array it returns (the pinned-buffer path of io/prefetch.py)."""
    data = _raw(-32, rng)
    p = str(tmp_path / "a.fits")
    twrite.write_fits_mono(p, data)
    shapes = []

    def alloc(shape):
        shapes.append(shape)
        return np.full(shape, -1.0, np.float32)

    img = tread.extract_image(p, alloc)
    assert shapes == [data.shape]
    np.testing.assert_array_equal(img.image, data)
    with pytest.raises(ValueError):
        tread.extract_image(p, lambda s: np.empty((3, 3), np.float32))


@pytest.mark.parametrize("bitpix", [-32, 16, -64])
@pytest.mark.parametrize("rgb", [False, True])
def test_fits_writers_byte_equal_to_jax(tmp_path, rng, bitpix, rgb):
    planes = [_raw(-32, rng, (23, 31)) * s for s in (1.0, 0.5, 0.25)]
    hdr = [("OBJECT", "M16"), ("CRVAL1", "1.25"), ("NAXIS1", "999"),
           ("BITPIX", "8"), ("EXPTIME", "300")]
    a, b = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    if rgb:
        twrite.write_fits_rgb(a, *planes, HduHeader(hdr), bitpix=bitpix)
        jwrite.write_fits_rgb(b, *planes, JHeader(hdr), bitpix=bitpix)
    else:
        twrite.write_fits_mono(a, planes[0], HduHeader(hdr), bitpix=bitpix)
        jwrite.write_fits_mono(b, planes[0], JHeader(hdr), bitpix=bitpix)
    got = open(a, "rb").read()
    assert len(got) % 2880 == 0
    assert got == open(b, "rb").read()


def _decode_png(path):
    """(pixels, bit depth, colour type) of a PNG whose scanlines all use
    filter 0, decoded with zlib alone."""
    blob = open(path, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + data
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    chans = {0: 1, 2: 3}[colour]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * chans * depth // 8)
    assert not rows[:, 0].any()    # filter 0 on every scanline
    px = rows[:, 1:].copy().view(">u2" if depth == 16 else np.uint8)
    return px.reshape((h, w) if chans == 1 else (h, w, 3)), depth, colour


# The second size of each depth makes ~4.2 MB of scanlines: two deflate
# bands (io/png.band_rows) over an odd row count.
@pytest.mark.parametrize("bit_depth,shape", [
    pytest.param(8, (29, 41), id="8"),
    pytest.param(16, (29, 41), id="16"),
    pytest.param(8, (1031, 4099), id="8-banded"),
    pytest.param(16, (1031, 2050), id="16-banded")])
def test_gray_png_decodes_to_jax_pixels(tmp_path, rng, bit_depth, shape):
    top = 255 if bit_depth == 8 else 65535
    px = rng.integers(0, top + 1, shape)
    px[0, :2] = (0, top)
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tpng.save_gray_png(px, a, bit_depth)
    jpng.save_gray_png(px, b, bit_depth)
    got, depth, colour = _decode_png(a)
    assert (depth, colour) == (bit_depth, 0)
    np.testing.assert_array_equal(got, np.asarray(Image.open(b)))
    np.testing.assert_array_equal(got, px)


@pytest.mark.parametrize("bit_depth,shape", [
    pytest.param(8, (13, 19), id="8"),
    pytest.param(16, (13, 19), id="16"),
    pytest.param(8, (1031, 1366), id="8-banded"),
    pytest.param(16, (1031, 683), id="16-banded")])
def test_rgb_png_decodes_to_jax_pixels(tmp_path, rng, bit_depth, shape):
    top = 255 if bit_depth == 8 else 65535
    r, g, b_ = (rng.integers(0, top + 1, shape) for _ in range(3))
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tpng.save_rgb_png(r, g, b_, a, bit_depth)
    jpng.save_rgb_png(r, g, b_, b, bit_depth)
    got, depth, colour = _decode_png(a)
    assert (depth, colour) == (bit_depth, 2)
    np.testing.assert_array_equal(got, _decode_png(b)[0] if bit_depth == 16
                                  else np.asarray(Image.open(b)))
    np.testing.assert_array_equal(got, np.stack([r, g, b_], -1))


def _image_tree(root, rng):
    os.makedirs(root / "sub")
    for name in ("b.fits", "a.FIT", "sub/c.fts", "d.asdf", "notes.txt",
                 "sub/e.fits"):
        twrite.write_fits_mono(str(root / name), _raw(-32, rng, (4, 4)))


def test_resolve_inputs_matches_jax_on_a_directory_and_a_zip(tmp_path, rng):
    root = tmp_path / "frames"
    _image_tree(root, rng)
    assert tdisp.resolve_inputs(str(root)) == jdisp.resolve_inputs(str(root))
    z = tmp_path / "frames.zip"
    with zipfile.ZipFile(z, "w") as zf:
        for dirpath, _dirs, files in os.walk(root):
            for name in files:
                full = os.path.join(dirpath, name)
                zf.write(full, os.path.relpath(full, root))
        zf.writestr("../escape.fits", b"x")    # dropped: path traversal
    got, want = tdisp.resolve_inputs(str(z)), jdisp.resolve_inputs(str(z))
    rel = [os.path.relpath(p, os.path.dirname(got[0])) for p in got]
    assert rel == [os.path.relpath(p, os.path.dirname(want[0]))
                   for p in want]
    assert [open(p, "rb").read() for p in got] == \
        [open(p, "rb").read() for p in want]
    single = str(root / "b.fits")
    assert tdisp.resolve_single_image(single) == \
        jdisp.resolve_single_image(single) == single
    for bad in (str(tmp_path / "missing.fits"), str(tmp_path / "empty")):
        if bad.endswith("empty"):
            os.makedirs(bad)
        with pytest.raises(te.InvalidInput):
            tdisp.resolve_inputs(bad)
        with pytest.raises(je.InvalidInput):
            jdisp.resolve_inputs(bad)


def test_asdf_input_raises_invalid_input(tmp_path, rng):
    """ASDF paths resolve as in the JAX dispatcher; a missing one, and a
    JWST calibration-reference name (common.rs:30-56), raise
    InvalidInput in both packages."""
    from astroburst_tpu.api import common as jcommon
    from astroburst_tpu_torch.api import common as tcommon
    p = tmp_path / "frame.asdf"
    p.write_bytes(b"#ASDF 1.0.0\n")
    for t_fn, j_fn in ((tdisp.resolve_inputs, jdisp.resolve_inputs),
                       (tdisp.resolve_single_image,
                        jdisp.resolve_single_image)):
        assert t_fn(str(p)) == j_fn(str(p))
    d = tmp_path / "only_asdf"
    d.mkdir()
    (d / "x.asdf").write_bytes(b"#ASDF 1.0.0\n")
    assert tdisp.resolve_inputs(str(d)) == [str(d / "x.asdf")]
    assert tdisp.resolve_single_image(str(d)) == \
        jdisp.resolve_single_image(str(d)) == str(d / "x.asdf")
    with pytest.raises(te.InvalidInput):
        tdisp.resolve_single_image(str(tmp_path / "missing.asdf"))
    ref = tmp_path / "jwst_nircam_photom_0042.asdf"
    ref.write_bytes(b"#ASDF 1.0.0\n")
    with pytest.raises(te.InvalidInput, match="photom"):
        tcommon.extract_image_resolved(str(ref))
    with pytest.raises(je.InvalidInput, match="photom"):
        jcommon.extract_image_resolved(str(ref))


def _cache_trace(mod, make):
    """Keys after each step of one sequence of cache operations."""
    c = mod.ImageCache(max_entries=3, max_bytes=5 * 64)
    trace = []
    for step in (("insert", "k0", 16), ("insert", "k1", 16),
                 ("insert", "__composite_r", 16), ("get", "k0"),
                 ("insert", "k2", 16), ("insert", "__star_mask", 16),
                 ("insert", "__wizard_ch_1_bg", 16), ("insert", "k3", 16),
                 ("get", "k3"), ("insert", "big", 64), ("remove", "k3"),
                 ("insert", "k4", 4), ("insert", "k5", 4)):
        if step[0] == "insert":
            c.insert(step[1], make(step[2]))
        elif step[0] == "get":
            c.get(step[1])
        else:
            c.remove(step[1])
        trace.append(sorted(c.keys()))
    return trace


def test_cache_lru_byte_cap_and_pinned_keys_match_jax():
    got = _cache_trace(tcache, lambda n: torch.ones(n))
    want = _cache_trace(jcache, lambda n: jnp.ones(n))
    assert got == want
    assert "__composite_r" in got[-1] and "__star_mask" in got[-1]


def test_cache_entries_stats_header_and_devices():
    c = tcache.ImageCache()
    e = c.insert("a", np.arange(6, dtype=np.float64).reshape(2, 3),
                 header=HduHeader([("X", "1")]), device=CPU)
    assert e.image.dtype == torch.float32 and e.image.device == CPU
    assert e.nbytes == 24
    st = ImageStats(min=1.0, valid_count=3)
    c.upgrade_stats("a", st)
    c.upgrade_stats("a", ImageStats(min=9.0))    # first stats stay
    c.upgrade_header("a", HduHeader([("Y", "2")]))
    assert c.get("a", CPU).stats == st and c.get("a").header.get("X") == "1"
    # another device's lookup never gets this entry's tensor
    assert c.get("a", torch.device("meta")) is None
    with pytest.raises(te.CacheMiss):
        c.require("a", torch.device("meta"))
    assert c.contains("a")
    loaded = c.get_or_load("b", lambda: (np.ones((2, 2)), None, None), CPU)
    assert loaded is c.require("b")
    assert c.remove_prefix("b") == 1 and c.keys() == ["a"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            c.insert("np", np.ones(2))   # arrays default to cuda_device()


def test_progress_handle_emits_the_same_events(monkeypatch):
    """The same ticks on a clock that advances 20 ms a reading (the
    throttle is 50 ms) give the same payloads."""
    got, want = [], []
    tprog.subscribe("stack-progress", got.append)
    jprog.subscribe("stack-progress", want.append)
    try:
        for mod in (tprog, jprog):
            clock = iter(np.arange(1.0, 100.0, 0.02).tolist())
            monkeypatch.setattr(mod.time, "monotonic",
                                lambda clock=clock: next(clock))
            h = mod.ProgressHandle("stack-progress", total=7)
            h.tick()
            for _ in range(4):
                h.tick_with_stage("align")
            h.emit_stage("combine")
            h.tick_with_stage("combine", 2)
            h.cancel()
            assert h.is_cancelled()
    finally:
        tprog.unsubscribe("stack-progress", got.append)
        jprog.unsubscribe("stack-progress", want.append)
    assert got == want and len(got) >= 3
    with pytest.raises(te.Cancelled):
        h = tprog.ProgressHandle("x")
        h.cancel()
        h.check_cancelled()


def test_output_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("ASTROBURST_DATA_DIR", str(tmp_path / "data"))
    assert tout.default_output_dir() == str(tmp_path / "data" / "output")
    assert tout.resolve_output_dir(str(tmp_path / "o")) == \
        str(tmp_path / "o")
    assert tout.resolve_output_dir("") == str(tmp_path / "data" / "output")
    assert os.path.isdir(tmp_path / "data" / "output")


@pytest.mark.parametrize("shape,max_dim", [
    ((5655, 2206), 4096), ((300, 200), 64), ((1001, 999), 512),
    ((7, 4096 * 3 + 1), 4096), ((100, 90), 128)])
def test_nearest_downsample_index_map_matches_jax(shape, max_dim):
    h, w = shape
    x = np.arange(h * w, dtype=np.float32).reshape(h, w)  # exact < 2**24
    got = tipc.nearest_downsample(torch.from_numpy(x), max_dim).numpy()
    want = np.asarray(jipc.nearest_downsample(jnp.asarray(x), max_dim))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if shape == (5655, 2206):
        assert got.shape == (4096, 1598)
        rows = (got[:, 0] // w).astype(np.int64)
        f64 = np.minimum((np.arange(4096) * (h / 4096)).astype(np.int64),
                         h - 1)
        assert int((rows != f64).sum()) == 1   # why the map stays f32


@pytest.mark.parametrize("shape", [(61, 67), (2000, 2000), (2001, 2000)])
def test_compute_image_stats_matches_jax(rng, shape):
    """Up to 4e6 pixels (2000 x 2000) the exact even-averaging median,
    above it (2001 x 2000) the single rank, on both sides."""
    x = rng.normal(100.0, 5.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.01] = np.nan
    x[:2, :3] = ((0.0, np.inf, -np.inf), (1e-8, 5e-8, -3.0))
    got = tstats.compute_image_stats(torch.from_numpy(x))
    want = jstats.compute_image_stats(jnp.asarray(x))
    assert isinstance(got, ImageStats)
    assert got.valid_count == want.valid_count
    assert (got.min, got.max) == (want.min, want.max)
    tol = 2 * (want.max - want.min) * C5
    assert abs(got.median - want.median) <= tol
    assert abs(got.mad - want.mad) <= tol
    assert abs(got.sigma - want.sigma) <= tol * 1.4826
    assert got.mean == pytest.approx(want.mean, rel=1e-6)


def test_compute_image_stats_exact_switch_and_empty():
    assert tstats.EXACT_PATH_MAX_PIXELS == jstats.EXACT_PATH_MAX_PIXELS
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])   # exact pair: (2 + 3) / 2
    assert tstats.compute_image_stats(x).median == 2.5
    empty = torch.full((3, 3), float("nan"))
    assert tstats.compute_image_stats(empty) == ImageStats()


def _stats_pair(x):
    j = jstats.compute_image_stats(jnp.asarray(x))
    return ImageStats(**dataclasses.asdict(j)), j


@pytest.mark.parametrize("case", ["field", "flat", "empty", "bright"])
def test_auto_stf_and_apply_stf_u8_bit_equal_to_jax(rng, case):
    x = rng.gamma(2.0, 20.0, (97, 131)).astype(np.float32) + 50.0
    x[rng.random(x.shape) < 0.02] = np.nan
    x[3, :4] = (0.0, np.inf, 1e-8, -5.0)
    if case == "flat":
        x[np.isfinite(x)] = 7.0
    elif case == "empty":
        x[:] = np.nan
    elif case == "bright":
        x[10:20, 10:20] = 1e6
    st, jst = _stats_pair(x)
    got, want = tstf.auto_stf(st), jstf.auto_stf(jst)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    u8 = tstf.apply_stf_u8(torch.from_numpy(x), got, st).numpy()
    np.testing.assert_array_equal(
        u8, np.asarray(jstf.apply_stf_u8(jnp.asarray(x), want, jst)))
    f32 = tstf.apply_stf_f32(torch.from_numpy(x), got, st).numpy()
    np.testing.assert_allclose(
        f32, np.asarray(jstf.apply_stf_f32(jnp.asarray(x), want, jst)),
        rtol=1e-6, atol=1e-7)
    for v in (-0.5, 0.0, 0.3, 1.0, 2.0):
        for m in (1e-4, 0.25, 0.5, 0.9999):
            assert tstf.mtf(v, m) == jstf.mtf(v, m)
            assert tstf.mtf_balance(v, m) == jstf.mtf_balance(v, m)
    custom = StfParams(shadow=0.1, midtone=0.3)
    np.testing.assert_array_equal(
        tstf.apply_stf_u8(torch.from_numpy(x), custom, st).numpy(),
        np.asarray(jstf.apply_stf_u8(jnp.asarray(x), JStf(0.1, 0.3), jst)))


def test_prefetch_yields_frames_in_order_on_the_cpu(tmp_path, rng):
    frames = [_raw(-32, rng, (12 + k % 3, 15)) for k in range(5)]
    paths = []
    for k, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{k}.fits"))
        twrite.write_fits_mono(paths[-1], f, HduHeader([("IDX", str(k))]))
    got = list(tpre.prefetch_images(paths, depth=2, device=CPU))
    for k, img in enumerate(got):
        assert isinstance(img.image, torch.Tensor)
        assert not img.image.is_pinned()
        np.testing.assert_array_equal(img.image.numpy(), frames[k])
        assert img.header.get("IDX") == str(k)
    stack, headers = tpre.PrefetchingStackLoader(
        depth=3, preprocess=lambda t: t * 2.0, device=CPU).load_stack(paths)
    assert stack.shape == (5, 12, 15)
    np.testing.assert_array_equal(stack[4].numpy(), frames[4][:12] * 2.0)
    assert [h.get("IDX") for h in headers] == [str(k) for k in range(5)]
    with pytest.raises(ValueError):
        next(tpre.prefetch_images(paths, depth=0, device=CPU))


def test_errors_keep_the_jax_hierarchy():
    for name in ("FitsError", "AsdfError", "InvalidInput", "Cancelled",
                 "CacheMiss"):
        assert issubclass(getattr(te, name), te.AstroError)
        assert issubclass(getattr(je, name), je.AstroError)
    assert str(te.Cancelled()) == str(je.Cancelled())
