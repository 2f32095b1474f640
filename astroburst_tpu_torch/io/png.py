"""PNG encoding (reference: src-tauri/src/infra/render/{grayscale,rgb}.rs).

Every PNG is written by a direct chunk writer (signature + IHDR + one
IDAT holding one zlib stream + IEND), as astroburst_tpu/io/png.py
writes its 16-bit RGB: no Pillow, which the card's machine does not
have. Samples are big-endian, as the PNG spec says. Scanlines use
filter 0 (None), and zlib runs at level 6 (Pillow's default): filter
and level change only the compressed stream, not the decoded pixels.

The stream is deflated in row bands, pigz style. The plan
(``band_rows``) takes ``scanline bytes // BAND_BYTES`` bands of whole
rows, at least one and at most one a row, as even as the rows allow.
Past ``POOL_WIDTH`` bands the count is rounded up to a whole multiple
of it, so that every round of the pool is full: a 4096 x 1598 RGB
preview's 9 bands of 2.2 MiB take two bands' time on 8 threads, its 16
bands of 1.2 MiB about one band's.

- One band is ``zlib.compress(scanlines, 6)`` on the calling thread:
  every PNG of less than ``2 * BAND_BYTES`` of scanlines.
- Several bands are deflated at once on a pool of threads (zlib lets go
  of the GIL). Each band is raw deflate primed with the 32 KiB of
  scanlines before it, so its matches reach back across the cut as one
  stream's would; every band but the last ends on a byte boundary with
  a sync flush, the last with the final block. The caller writes the
  zlib header, the bands in order, and the Adler-32 of the whole,
  combined from the bands' own (``adler32_combine``). The chunk's CRC
  runs over each band as it comes back, and a file is written from the
  pieces as they are: nothing is joined.

The plan depends only on the image's shape and bit depth, never on the
machine or the pool's size, so a PNG's bytes are a function of its
pixels alone.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime import trace

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB = 0, 2   # PNG colour types

BAND_BYTES = 2 << 20          # scanline bytes a deflate band takes
POOL_WIDTH = 8                # the bands' threads, at most
_WINDOW = 32 << 10            # deflate's window: a band's dictionary
_ZLIB_HEADER = b"\x78\x9c"    # deflate, 32 KiB window, level 6, no dict
_ADLER_MOD = 65521
_IDAT_CRC = zlib.crc32(b"IDAT")

_pool = None                  # the bands' threads, made on first use
_pool_lock = threading.Lock()


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


_IEND = _png_chunk(b"IEND", b"")


def band_rows(h: int, nbytes: int) -> List[int]:
    """The first row of each band of ``h`` rows of ``nbytes`` scanline
    bytes in all, then ``h``: ``nbytes // BAND_BYTES`` bands, past
    ``POOL_WIDTH`` rounded up to a multiple of it, at least one and at
    most ``h``, as even as whole rows allow."""
    n = nbytes // BAND_BYTES
    if n > POOL_WIDTH:
        n = -(-n // POOL_WIDTH) * POOL_WIDTH
    n = max(1, min(h, n))
    return [i * h // n for i in range(n + 1)]


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """The Adler-32 of A + B from A's, B's and B's length in bytes
    (zlib's ``adler32_combine``)."""
    a1, b1 = adler1 & 0xFFFF, adler1 >> 16
    a2, b2 = adler2 & 0xFFFF, adler2 >> 16
    a = (a1 + a2 - 1) % _ADLER_MOD
    b = (b1 + b2 + len2 * (a1 - 1)) % _ADLER_MOD
    return b << 16 | a


def _band_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(min(POOL_WIDTH,
                                           os.cpu_count() or 1),
                                       thread_name_prefix="png-band")
        return _pool


def _deflate_band(raw: memoryview, start: int, end: int
                  ) -> Tuple[Tuple[bytes, bytes], int]:
    """``raw[start:end]`` as raw deflate at level 6, primed with the
    window before it; ended by a sync flush, or by the final block where
    it ends ``raw``. Returns the deflate's two pieces and the band's
    Adler-32."""
    band = raw[start:end]
    primer = {"zdict": raw[max(0, start - _WINDOW):start]} if start else {}
    z = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY,
                         **primer)
    body = z.compress(band)
    end_mode = zlib.Z_FINISH if end == raw.nbytes else zlib.Z_SYNC_FLUSH
    return (body, z.flush(end_mode)), zlib.adler32(band)


def _zlib_stream(scanlines: np.ndarray) -> Tuple[List[bytes], int]:
    """The [h, row bytes] scanlines as one zlib stream at level 6, in
    pieces, and the CRC of the IDAT chunk that holds them."""
    h, row = scanlines.shape
    rows = band_rows(h, scanlines.nbytes)
    trace.count("io.png.bands", len(rows) - 1)
    if len(rows) == 2:
        stream = zlib.compress(scanlines, 6)
        return [stream], zlib.crc32(stream, _IDAT_CRC)
    raw = memoryview(scanlines.reshape(-1))
    cuts = [r * row for r in rows]
    pool = _band_pool()
    futures = [pool.submit(_deflate_band, raw, a, b)
               for a, b in zip(cuts, cuts[1:])]
    stream = [_ZLIB_HEADER]
    crc, adler = zlib.crc32(_ZLIB_HEADER, _IDAT_CRC), 1
    for fut, a, b in zip(futures, cuts, cuts[1:]):
        pieces, band_adler = fut.result()
        for p in pieces:
            crc = zlib.crc32(p, crc)
        stream += pieces
        adler = adler32_combine(adler, band_adler, b - a)
    tail = struct.pack(">I", adler)
    stream.append(tail)
    return stream, zlib.crc32(tail, crc)


def _png_pieces(samples: np.ndarray, bit_depth: int, colour: int
                ) -> List[bytes]:
    """The PNG file of [H, W] (gray) or [H, W, 3] (RGB) samples cast to
    u8 at ``bit_depth`` 8 or to big-endian u16 at 16, as pieces to be
    written in order."""
    dtype = ">u2" if bit_depth == 16 else np.uint8
    with trace.span("io.png.scanlines"):
        arr = np.ascontiguousarray(samples, dtype=dtype)
        h, w = arr.shape[:2]
        raw = arr.view(np.uint8).reshape(h, -1)
        scanlines = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    with trace.span("io.png.deflate"):
        trace.count("io.png.raw_bytes", scanlines.nbytes)
        stream, crc = _zlib_stream(scanlines)
        size = sum(map(len, stream))
        trace.count("io.png.out_bytes", size)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, colour, 0, 0, 0)
    return [_SIGNATURE, _png_chunk(b"IHDR", ihdr),
            struct.pack(">I", size) + b"IDAT", *stream,
            struct.pack(">I", crc), _IEND]


def _gray_pieces(pixels: np.ndarray, bit_depth: int) -> List[bytes]:
    arr = np.asarray(pixels)
    if arr.ndim != 2:
        raise InvalidInput(f"expected 2D grayscale, got {arr.shape}")
    return _png_pieces(arr, 16 if bit_depth == 16 else 8, _GRAY)


def encode_gray_png(pixels: np.ndarray, bit_depth: int = 8) -> bytes:
    """A mono u8 (or u16 at bit_depth 16) plane as PNG bytes in memory."""
    return b"".join(_gray_pieces(pixels, bit_depth))


def _save(path: str, pieces: List[bytes]) -> None:
    with trace.span("io.write"), open(path, "wb") as f:
        f.writelines(pieces)


def save_gray_png(pixels: np.ndarray, path: str, bit_depth: int = 8) -> None:
    """Save a mono u8 (or u16 at bit_depth 16) plane as PNG."""
    _save(path, _gray_pieces(pixels, bit_depth))


def save_rgb_png(r: np.ndarray, g: np.ndarray, b: np.ndarray, path: str,
                 bit_depth: int = 8) -> None:
    """Save three planes as an RGB PNG (u8, or true u16 at bit_depth 16,
    the reference's Rgb16 export, rgb.rs:49-95)."""
    rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    _save(path, _png_pieces(rgb, 16 if bit_depth == 16 else 8, _RGB))
