"""PyTorch port: the PNG writer's banded deflate (``io/png``).

- one band is today's stream: ``zlib.compress`` of the scanlines at
  level 6, byte for byte;
- several bands make one zlib stream in one IDAT that inflates to the
  scanlines, gray and RGB, 8 and 16 bits, at 2, 3, 8 and 16 bands (9
  rounded up) over row counts the band count does not divide;
- the band plan; ``adler32_combine`` against ``zlib.adler32`` of the
  whole;
- the bytes do not depend on the pool's size, nor on callers on other
  threads;
- tracing: one ``io.png.deflate`` span a PNG on the caller's thread, and
  the counters ``io.png.bands``, ``io.png.raw_bytes``,
  ``io.png.out_bytes``.
"""

import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from astroburst_tpu_torch.io import png
from astroburst_tpu_torch.runtime import trace


def _chunks(blob):
    """[(tag, payload)] of a PNG, each chunk's CRC checked."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data)
        out.append((tag, data))
        pos += 12 + n
    return out


def _idat(blob):
    chunks = _chunks(blob)
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    return chunks[1][1]


def _scanlines(samples, bit_depth):
    arr = np.ascontiguousarray(samples,
                               ">u2" if bit_depth == 16 else np.uint8)
    raw = arr.view(np.uint8).reshape(arr.shape[0], -1)
    return np.concatenate([np.zeros((raw.shape[0], 1), np.uint8), raw], 1)


def _image(rng, shape, bit_depth):
    """A sky: a smooth gradient under noise, so deflate finds matches
    (across the bands' cuts too) and literals."""
    top = 255 if bit_depth == 8 else 65535
    ramp = np.linspace(0.1, 0.6, shape[1])[None, :]
    if len(shape) == 3:
        ramp = ramp[..., None]
    sky = top * ramp + rng.normal(0.0, top / 40, shape)
    return np.clip(sky, 0, top).astype(np.int64)


@pytest.fixture
def tracing():
    """Tracing on and the recorder empty for the test; as it was after."""
    was = trace.enabled()
    trace.drain()
    trace.enable()
    yield
    trace.drain()
    if not was:
        trace.disable()


def test_one_band_is_one_zlib_compress_byte_for_byte(rng):
    px = _image(rng, (512, 512), 8).astype(np.uint8)
    sl = _scanlines(px, 8)
    assert png.band_rows(512, sl.nbytes) == [0, 512]
    blob = png.encode_gray_png(px)
    assert _idat(blob) == zlib.compress(sl, 6)
    assert blob.endswith(png._png_chunk(b"IEND", b""))


# Rows 1031, 1543, 4097 of ~4100 scanline bytes: 2, 3 and 8 bands, none
# of which divides its row count.
_WIDTHS = {("gray", 8): 4099, ("gray", 16): 2050,
           ("rgb", 8): 1366, ("rgb", 16): 683}


@pytest.mark.parametrize("rows,bands", [(1031, 2), (1543, 3), (4097, 8),
                                        (4605, 16)])
@pytest.mark.parametrize("kind,bit_depth", list(_WIDTHS))
def test_bands_inflate_to_the_scanlines(tmp_path, rng, kind, bit_depth, rows,
                                        bands):
    w = _WIDTHS[kind, bit_depth]
    shape = (rows, w) if kind == "gray" else (rows, w, 3)
    px = _image(rng, shape, bit_depth)
    sl = _scanlines(px, bit_depth)
    plan = png.band_rows(rows, sl.nbytes)
    assert len(plan) - 1 == bands and plan[0] == 0 and plan[-1] == rows
    assert max(np.diff(plan)) - min(np.diff(plan)) <= 1
    path = str(tmp_path / "b.png")
    if kind == "gray":
        png.save_gray_png(px, path, bit_depth)
    else:
        png.save_rgb_png(px[..., 0], px[..., 1], px[..., 2], path, bit_depth)
    idat = _idat(open(path, "rb").read())
    assert idat[:2] == b"\x78\x9c"
    d = zlib.decompressobj()
    assert d.decompress(idat) == sl.tobytes()
    assert d.eof and d.unused_data == b""       # one stream, checksum read
    # within 0.1% of one stream's size, as the window crosses each cut
    assert len(idat) <= 1.001 * len(zlib.compress(sl, 6))


@pytest.mark.parametrize("h,nbytes,n", [
    (4096, 4096 * 4097, 8),           # the 4096² u8 preview
    (512, 512 * 513, 1),              # a cube's 512² preview
    (4096, 4096 * (1 + 3 * 4096), 24),  # a 4096² RGB u8
    (1598, 1598 * (1 + 3 * 4096), 16),  # 9 bands, rounded up to 16
    (4096, 4096 * (1 + 4 * 4096), 32),  # 32: a multiple of 8 already
    (4096, 4096 * (1 + 3 * 4800), 32),  # 28 bands, rounded up to 32
    (12, 12 * (1 << 20), 6),          # 12 MiB: 6 bands, not rounded
    (3, 3 * (5 << 20), 3),            # rows past a band each: one a row
    (2, 2 * (9 << 20), 2),
    (1, 1, 1), (0, 0, 1)])
def test_band_plan_follows_the_scanline_bytes(h, nbytes, n):
    plan = png.band_rows(h, nbytes)
    assert len(plan) - 1 == n and plan[0] == 0 and plan[-1] == h
    assert list(plan) == sorted(plan)


@pytest.mark.parametrize("seed", range(6))
def test_adler32_combine_equals_the_whole(seed):
    r = np.random.default_rng(seed)
    data = r.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    if seed == 0:
        data = b"\xff" * 300_000           # the sums' largest terms
    # random cuts in the first 70 000 bytes; then 1 byte, ~230 000, 1
    cuts = sorted(r.integers(1, 70_000, 5).tolist()
                  + [0, 0, 1, 70_000, 70_001, len(data) - 1])
    bounds = [0, *cuts, len(data)]
    parts = [data[a:b] for a, b in zip(bounds, bounds[1:])]
    assert any(len(p) == 0 for p in parts)
    assert any(len(p) == 1 for p in parts)
    assert any(len(p) > 65521 for p in parts)
    got = 1
    for p in parts:
        got = png.adler32_combine(got, zlib.adler32(p), len(p))
    assert got == zlib.adler32(data)


def test_bytes_do_not_depend_on_the_pool_size(rng, monkeypatch):
    px = _image(rng, (4097, 4099), 8)
    got = []
    for workers in (1, 8):
        with ThreadPoolExecutor(workers) as pool:
            monkeypatch.setattr(png, "_pool", pool)
            got.append(png.encode_gray_png(px))
    assert got[0] == got[1]
    assert len(png.band_rows(4097, 4097 * 4100)) - 1 == 8


def test_callers_on_other_threads_share_the_pool(rng):
    """Six threads each write a banded PNG while the others do; every
    file is the one a single caller writes."""
    px = [_image(rng, (1543, 4099), 8) for _ in range(6)]
    want = [png.encode_gray_png(p) for p in px]
    with ThreadPoolExecutor(6) as callers:
        futs = [callers.submit(png.encode_gray_png, p) for p in px]
        got = [f.result(timeout=120) for f in futs]
    assert got == want


@pytest.mark.parametrize("shape,bands", [((512, 512), 1), ((4097, 4099), 8)])
def test_one_deflate_span_a_png_on_the_callers_thread(tmp_path, rng, tracing,
                                                      shape, bands):
    px = _image(rng, shape, 8)
    png.save_gray_png(px, str(tmp_path / "a.png"))
    blob = png.encode_gray_png(px)
    got = trace.drain()
    deflates = [s for s in got.spans if s.name == "io.png.deflate"]
    assert len(deflates) == 2
    assert {s.thread for s in got.spans} == {threading.get_ident()}
    assert got.counters["io.png.bands"] == 2 * bands
    assert got.counters["io.png.raw_bytes"] == 2 * shape[0] * (shape[1] + 1)
    assert got.counters["io.png.out_bytes"] == 2 * len(_idat(blob))
    assert [s.name for s in got.spans].count("io.write") == 1
