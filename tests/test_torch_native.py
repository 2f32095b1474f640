"""PyTorch port: the host FITS codec (``astroburst_tpu_torch/native``,
C++/OpenMP built with g++ at first use) against its plain numpy versions
and the JAX package's decode, on the CPU.

- decode, bit for bit (``uint32`` views) against
  ``io/fits_reader.decode_pixels_plain``: every BITPIX {8, 16, 32, -32,
  -64}, at identity scaling, (0.37, 32768), ROADMAP C32's (0.01, 20)
  and (2, 0); NaN with payloads, signalling NaN, +-inf, +-0.0, f32 and
  f64 subnormals, f64 values past the f32 range; n = 0, 1, 7 and
  1 000 003; sources at odd byte offsets of a memory map; into a
  caller's array; at 1, 3 and every thread (the wrapper's argument);
- decode against the JAX package (``astroburst_tpu.io.fits_reader.
  decode_pixels`` and ``astroburst_tpu.native.decode_pixels_native``)
  wherever the two define it the same way. Two exceptions are held to a
  numpy oracle instead: C32's cancelling terms (the JAX library's f64
  multiply-add contracts to an FMA and keeps a residue of -4.2e-16 where
  the port gives 0) and -0.0 (the JAX library adds bzero even when it is
  0, so -0.0 + 0.0 gives +0.0 at BITPIX -64 with identity scaling and at
  -32 and -64 with bscale != 1 and bzero 0; the port skips the add, as
  numpy does, and keeps -0.0);
- the encode (``encode_be_to_fd``, read back from the file it wrote):
  big-endian f32 equal to ``astype(">f4")``; i16 equal to the plain
  ``io/fits_writer._encode_plane`` (exact .5 ties, both clamps, +-inf,
  NaN as 0); files written through it byte-equal to the plain writer's,
  mono and RGB at BITPIX 16 and -32, planes of more than one 4 MB
  chunk; a failed write raises OSError;
- the routing: every FITS decode of the reader, the RGB planes, the
  cube, the lazy cube's frames and the loaders goes through the codec;
  BITPIX 16 and -32 writes through ``encode_be_to_fd``, -64 through
  numpy;
- the build: two processes that build on one cold build directory at
  once each load the library; a source that does not compile raises
  with g++'s log.
"""

import mmap
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from astroburst_tpu import native as jnative
from astroburst_tpu.io import fits_reader as jread
from astroburst_tpu_torch import native
from astroburst_tpu_torch.api import common as tcommon
from astroburst_tpu_torch.cube.lazy import LazyCube
from astroburst_tpu_torch.io import fits_reader as tread
from astroburst_tpu_torch.io import fits_writer as twrite
from astroburst_tpu_torch.io import prefetch as tpre
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

BITPIXES = (8, 16, 32, -32, -64)
SCALINGS = {"identity": (1.0, 0.0), "u16": (0.37, 32768.0),
            "c32": (0.01, 20.0), "x2": (2.0, 0.0)}
SIZES = (0, 1, 7, 1_000_003)

# f32 bit patterns: qNaN, sNaN, a negative NaN with a payload, +-inf,
# +-0.0, the smallest and largest subnormals, the smallest normal,
# +-FLT_MAX
F32_SPECIAL = np.array([0x7FC00000, 0x7F800001, 0xFFC00123, 0x7F800000,
                        0xFF800000, 0x80000000, 0x00000000, 0x00000001,
                        0x807FFFFF, 0x00800000, 0x7F7FFFFF, 0xFF7FFFFF],
                       np.uint32)
# f64 bit patterns: the same kinds, plus f64 subnormals, values that land
# on f32 subnormals and values past the f32 range
F64_SPECIAL = np.concatenate([
    np.array([0x7FF8000000000000, 0x7FF0000000000001, 0xFFF8000000012345,
              0x7FF0000000000000, 0xFFF0000000000000, 0x8000000000000000,
              0x0000000000000000, 0x0000000000000001, 0x800FFFFFFFFFFFFF],
             np.uint64),
    np.array([1e-40, -3e-42, 1e39, -1e300, 3.4028235677973366e38,
              -2000.0, 0.5], np.float64).view(np.uint64)])


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def raw_pixels(bitpix: int, n: int, seed: int) -> np.ndarray:
    """n big-endian pixels of ``bitpix``: the extremes and special
    values first, then random bit patterns and random values."""
    rng = np.random.default_rng(seed)
    if bitpix == 8:
        v = np.concatenate([[0, 255, 1], rng.integers(0, 256, n)])
        return v[:n].astype(">u1")
    if bitpix == 16:
        v = np.concatenate([[-32768, 32767, 0, -2000, 1],
                            rng.integers(-32768, 32768, n)])
        return v[:n].astype(">i2")
    if bitpix == 32:
        v = np.concatenate([[-2**31, 2**31 - 1, 0, -2000, 1],
                            rng.integers(-2**31, 2**31, n)])
        return v[:n].astype(">i4")
    if bitpix == -32:
        half = n // 2
        bits = rng.integers(0, 2**32, half, dtype=np.uint64).astype(np.uint32)
        vals = (rng.standard_normal(n - half) * 1e4).astype(np.float32)
        v = np.concatenate([F32_SPECIAL, bits, vals.view(np.uint32)])
        return v[:n].view(np.float32).astype(">f4")
    half = n // 2
    bits = rng.integers(0, 2**63, half, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, half, dtype=np.uint64)
    vals = rng.standard_normal(n - half) * 1e4
    v = np.concatenate([F64_SPECIAL, bits, vals.view(np.uint64)])
    return v[:n].view(np.float64).astype(">f8")


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("bitpix", BITPIXES)
def test_decode_matches_plain_bit_for_bit(bitpix, scaling, n):
    """The reader's decode (the codec) gives the plain numpy decode's
    bits, NaN payloads and signed zeros included."""
    bscale, bzero = SCALINGS[scaling]
    raw = raw_pixels(bitpix, n, seed=abs(bitpix) + n).tobytes()
    with np.errstate(invalid="ignore", over="ignore"):
        want = tread.decode_pixels_plain(raw, bitpix, bscale, bzero)
    got = tread.decode_pixels(raw, bitpix, bscale, bzero)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("threads", (1, 3, None))
@pytest.mark.parametrize("bitpix", (16, -32))
def test_decode_any_thread_count(bitpix, threads):
    raw = raw_pixels(bitpix, 1_000_003, seed=5).tobytes()
    for bscale, bzero in ((1.0, 0.0), (0.37, 32768.0)):
        with np.errstate(invalid="ignore"):
            want = tread.decode_pixels_plain(raw, bitpix, bscale, bzero)
        got = native.decode_pixels_native(raw, bitpix, bscale, bzero,
                                          threads=threads)
        np.testing.assert_array_equal(bits(got), bits(want))
    with pytest.raises(ValueError):
        native.decode_pixels_native(raw, bitpix, 1.0, 0.0, threads=0)


@pytest.mark.parametrize("offset", (1, 3))
@pytest.mark.parametrize("bitpix", BITPIXES)
def test_decode_from_odd_mmap_offset_into_caller_array(tmp_path, bitpix,
                                                       offset):
    """A memoryview slice of a memory map at an odd byte offset (as
    io/prefetch.load_cube passes its chunks), decoded into the caller's
    C-contiguous f32 array, which is returned."""
    n = 12_345
    raw = raw_pixels(bitpix, n, seed=offset).tobytes()
    path = tmp_path / "blob"
    path.write_bytes(b"\0" * offset + raw + b"\0" * 5)
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        src = view[offset:offset + len(raw)]
        out = np.full((n // 5, 5) if n % 5 == 0 else (n,), 7.0, np.float32)
        got = tread.decode_pixels(src, bitpix, 0.37, 32768.0, out)
        assert got is out
        with np.errstate(invalid="ignore", over="ignore"):
            want = tread.decode_pixels_plain(src, bitpix, 0.37, 32768.0)
        np.testing.assert_array_equal(bits(got.reshape(-1)), bits(want))
        with pytest.raises(ValueError):   # one element short
            tread.decode_pixels(src, bitpix, 1.0, 0.0,
                                np.empty(n - 1, np.float32))
        with pytest.raises(ValueError):   # not contiguous
            tread.decode_pixels(src, bitpix, 1.0, 0.0,
                                np.empty(2 * n, np.float32)[::2])
        with pytest.raises(ValueError):   # not f32
            tread.decode_pixels(src, bitpix, 1.0, 0.0,
                                np.empty(n, np.float64))
        del src, view
    with pytest.raises(tread.FitsError):
        tread.decode_pixels(raw, 64, 1.0, 0.0)


@pytest.mark.parametrize("scaling", ("identity", "u16", "x2"))
@pytest.mark.parametrize("bitpix", BITPIXES)
def test_decode_matches_jax(bitpix, scaling):
    """The codec against the JAX package's decode and its native library
    where the two define the decode the same way: data without -0.0
    (see test_decode_exceptions_to_jax) and scalings whose terms do not
    cancel (C32)."""
    bscale, bzero = SCALINGS[scaling]
    vals = raw_pixels(bitpix, 200_003, seed=77)
    if bitpix < 0:
        vals[vals == 0] = 0.0   # +0.0 in place of -0.0
    raw = vals.tobytes()
    got = tread.decode_pixels(raw, bitpix, bscale, bzero)
    with np.errstate(invalid="ignore", over="ignore"):
        want = jread.decode_pixels(raw, bitpix, bscale, bzero)
    np.testing.assert_array_equal(bits(got), bits(want))
    lib = jnative.decode_pixels_native(raw, bitpix, bscale, bzero)
    if lib is not None:   # the JAX package's library where it builds
        np.testing.assert_array_equal(bits(got), bits(lib))


@pytest.mark.parametrize("bitpix", BITPIXES)
def test_decode_exceptions_to_jax(bitpix):
    """Where the JAX library departs from numpy, the codec keeps numpy's
    bits, held to an oracle written out here: C32's (raw -2000, BSCALE
    0.01, BZERO 20) is (-2000 * 0.01) + 20 = +0.0, rounded after each
    operation (the JAX library's FMA keeps -4.2e-16); -0.0 stays -0.0
    wherever no bzero is added (the JAX library adds +0.0)."""
    if bitpix == 8:
        vals = np.array([200, 0], ">u1")
        raw = vals.tobytes()
        want = np.float32([(200 * 0.01) + 20.0, 20.0])
    else:
        vals = np.array([-2000, 0], {16: ">i2", 32: ">i4", -32: ">f4",
                                      -64: ">f8"}[bitpix])
        raw = vals.tobytes()
        want = np.float32([(np.float64(-2000.0) * 0.01) + 20.0, 20.0])
        assert bits(want)[0] == 0
    np.testing.assert_array_equal(
        bits(tread.decode_pixels(raw, bitpix, 0.01, 20.0)), bits(want))
    if bitpix > 0:
        return
    neg0 = np.array([-0.0, 0.0, -1.5], ">f4" if bitpix == -32 else ">f8")
    for bscale in (1.0, 2.0):
        got = tread.decode_pixels(neg0.tobytes(), bitpix, bscale, 0.0)
        want = np.float32([-0.0, 0.0, -1.5 * bscale])
        np.testing.assert_array_equal(bits(got), bits(want))
        assert np.signbit(got[0]) and not np.signbit(got[1])


def f32_payload(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.concatenate([F32_SPECIAL.view(np.float32),
                        (rng.standard_normal(n) * 300).astype(np.float32)])
    return v[:n]


def encoded(tmp_path, data, bitpix, bzero, bscale, threads=None) -> bytes:
    """The bytes ``encode_be_to_fd`` writes for ``data``."""
    path = tmp_path / f"enc{bitpix}.bin"
    with open(path, "wb") as f:
        native.encode_be_to_fd(data, f.fileno(), bitpix, bzero, bscale,
                               threads)
    return path.read_bytes()


@pytest.mark.parametrize("n", SIZES)
def test_encode_be_f32_matches_astype(tmp_path, n):
    data = f32_payload(n, seed=n)
    got = encoded(tmp_path, data, -32, 0.0, 1.0)
    assert got == data.astype(">f4").tobytes()
    assert encoded(tmp_path, data, -32, 0.0, 1.0, threads=1) == got


def i16_cases(seed: int):
    """(data, bzero, bscale): exact .5 ties of both signs, both clamps,
    +-inf, NaN and random values, at four scalings (at bscale 2.2 a
    product with 1/bscale rounds 8191 of the values near the ties the
    other way)."""
    rng = np.random.default_rng(seed)
    ties = np.arange(-40000, 40000, dtype=np.float64) + 0.5
    special = np.array([np.nan, np.inf, -np.inf, 32767.49, 32767.5, 32768.0,
                        -32768.49, -32768.5, -32769.0, 0.5, -0.5, -0.0,
                        1e30, -1e30], np.float64)
    rand = rng.standard_normal(1_000_003) * 20000.0
    phys = np.concatenate([special, ties, rand])
    out = []
    for bzero, bscale in ((0.0, 1.0), (32768.0 * 0.25, 0.25),
                          (-3.0, 0.5), (0.0, 2.2)):
        # data whose (v - bzero) / bscale is ``phys`` in exact f64 math
        data = (phys * bscale + bzero).astype(np.float32)
        out.append((data, bzero, bscale))
    return out


def test_encode_be_i16_matches_plain_encode(tmp_path):
    """i16 bytes equal the plain ``_encode_plane``: .5 ties round away
    from zero, both clamps, +-inf clamped, NaN written as 0 (the plain
    encode's explicit NaN → 0; casting NaN to an integer is undefined)."""
    for data, bzero, bscale in i16_cases(seed=3):
        want = twrite._encode_plane(data, 16, bzero, bscale)
        assert encoded(tmp_path, data, 16, bzero, bscale) == want.tobytes()
        nan = np.isnan(data)
        assert nan.any() and (want[nan] == 0).all()
        assert encoded(tmp_path, data, 16, bzero, bscale, threads=3) \
            == want.tobytes()
    ties = np.float32([0.5, -0.5, 1.5, -1.5, 2.5, -2.5])
    assert twrite._encode_plane(ties, 16, 0.0, 1.0).astype(int).tolist() \
        == [1, -1, 2, -2, 3, -3]
    assert encoded(tmp_path, np.float32([]), 16, 0.0, 1.0) == b""


@pytest.mark.parametrize("bitpix", (16, -32))
@pytest.mark.parametrize("rgb", (False, True), ids=("mono", "rgb"))
def test_fits_files_through_the_codec_equal_the_plain_writer(tmp_path,
                                                              bitpix, rgb):
    """``write_fits_mono`` / ``write_fits_rgb`` (header, each plane
    through ``encode_be_to_fd``, pad) write the plain writer's bytes;
    planes span more than one 4 MB chunk."""
    rng = np.random.default_rng(abs(bitpix) + rgb)
    rows, cols = (1100, 1000) if rgb else (2100, 1000)
    planes = [(rng.standard_normal((rows, cols)) * 50 + 100).astype(
        np.float32) for _ in range(3 if rgb else 1)]
    planes[0][3, :7] = [np.nan, np.inf, -np.inf, -0.0, 1e-42, 1e30, -1e30]
    header = twrite.HduHeader([("OBJECT", "'M31'"), ("EXPTIME", "30.0")])
    got = str(tmp_path / "codec.fits")
    want = str(tmp_path / "plain.fits")
    if rgb:
        twrite.write_fits_rgb(got, *planes, header=header, bitpix=bitpix)
        bzero, bscale = (twrite._compute_bzero_bscale(planes)
                         if bitpix == 16 else (0.0, 1.0))
    else:
        twrite.write_fits_mono(got, planes[0], header=header, bitpix=bitpix)
        bzero, bscale = (twrite._compute_bzero_bscale(planes)
                         if bitpix == 16 else (0.0, 1.0))
    hdr = twrite._header_bytes((rows, cols), bitpix, bzero, bscale, header,
                               rgb=rgb)
    twrite._write_fits_file_plain(want, hdr, planes, bitpix, bzero, bscale)
    with open(got, "rb") as a, open(want, "rb") as b:
        ga, gb = a.read(), b.read()
    assert len(ga) % 2880 == 0 and len(ga) == len(gb)
    assert ga == gb


def test_encode_be_to_fd_rejects_and_raises(tmp_path):
    data = np.ones(10, np.float32)
    path = tmp_path / "ro.bin"
    path.write_bytes(b"")
    with open(path, "rb") as f:   # a descriptor open for reading only
        with pytest.raises(OSError):
            native.encode_be_to_fd(data, f.fileno(), -32, 0.0, 1.0)
        with pytest.raises(ValueError):
            native.encode_be_to_fd(data, f.fileno(), -64, 0.0, 1.0)


def _recording(monkeypatch, module, name, pick):
    """Wrap ``module.name`` to append ``pick(args, kwargs)`` of each call
    (never the arguments themselves: a memoryview kept alive would stop
    the reader from closing its memory map)."""
    seen = []
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append(pick(args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_every_decode_and_write_goes_through_the_codec(tmp_path,
                                                       monkeypatch):
    """The reader's images, RGB planes, cubes, the lazy cube's frames and
    the loaders decode through the codec; BITPIX 16 and -32 writes go
    through encode_be_to_fd, -64 through numpy."""
    decodes = _recording(monkeypatch, tread, "decode_pixels_native",
                         lambda a, kw: a[1])   # BITPIX
    writes = _recording(monkeypatch, twrite, "encode_be_to_fd",
                        lambda a, kw: a[2])   # BITPIX
    rng = np.random.default_rng(2)
    planes = [rng.random((40, 30)).astype(np.float32) for _ in range(3)]
    mono, rgb = str(tmp_path / "m.fits"), str(tmp_path / "rgb.fits")
    twrite.write_fits_mono(mono, planes[0], bitpix=16)
    twrite.write_fits_rgb(rgb, *planes, bitpix=-32)
    assert writes == [16, -32, -32, -32]
    twrite.write_fits_mono(str(tmp_path / "d.fits"), planes[0], bitpix=-64)
    assert writes == [16, -32, -32, -32]

    def count(fn):
        before = len(decodes)
        fn()
        return len(decodes) - before

    assert count(lambda: tread.extract_image(mono)) == 1
    assert count(lambda: tread.try_extract_rgb(rgb)) == 3
    assert count(lambda: tread.extract_cube(rgb)) == 1
    with LazyCube(rgb) as cube:
        assert count(lambda: cube.get_frame(2)) == 1
    assert count(lambda: tpre.load_cube(rgb, CPU)) == 1
    assert count(lambda: tpre.DeviceLoader(CPU)(mono)) == 1
    paths = [mono, str(tmp_path / "d.fits")]
    assert count(lambda: list(tpre.prefetch_images(paths, device=CPU))) == 2
    assert count(lambda: tcommon.load_cached_many(paths, device=CPU)) == 2
    # each pool decodes both files, in either order
    assert sorted(decodes[-4:-2]) == sorted(decodes[-2:]) == [-64, 16]


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "astro_io.cpp"
    bad.write_text('extern "C" int astro_decode_pixels( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native._kernels, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="did not build") as e:
        native._build()
    assert "error" in str(e.value) and str(bad) in str(e.value)
    assert not list((tmp_path / "build").rglob("*.so"))


CHILD = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from astroburst_tpu_torch import native
    root = Path(sys.argv[1])
    native._kernels.BUILD_ROOT = root / "build"
    (root / f"ready-{sys.argv[2]}").touch()
    while not (root / "go").exists():
        time.sleep(0.01)
    codec = native.library()
    out = native.decode_pixels_native(b"\\x00\\x07\\xff\\xfe", 16, 1.0, 0.0)
    assert out.tolist() == [7.0, -2.0], out
    print(codec.path)
""")


def test_two_processes_build_one_cold_directory(tmp_path):
    """Both builders start on an empty build directory at the same
    moment; each ends with a loadable library at the one path, and no
    temporary file is left."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path),
                               str(i)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready-{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline, "children never got ready"
            assert all(p.poll() is None for p in procs), \
                [p.communicate() for p in procs]
            time.sleep(0.01)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in (tmp_path / "build").rglob("*")
                   if p.is_file())
    assert built == ["build.log", "libastro_io.so"]
