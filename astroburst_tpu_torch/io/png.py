"""PNG encoding (reference: src-tauri/src/infra/render/{grayscale,rgb}.rs).

Every PNG is written by a direct chunk writer (signature + IHDR + one
zlib IDAT + IEND), as astroburst_tpu/io/png.py writes its 16-bit RGB:
no Pillow, which the card's machine does not have. Samples are
big-endian, as the PNG spec says. Scanlines use filter 0 (None), and
zlib runs at level 6 (Pillow's default): filter and level change only
the compressed stream, not the decoded pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime import trace

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB = 0, 2   # PNG colour types


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _png_bytes(samples: np.ndarray, bit_depth: int, colour: int) -> bytes:
    """The PNG file of [H, W] (gray) or [H, W, 3] (RGB) samples cast to
    u8 at ``bit_depth`` 8 or to big-endian u16 at 16."""
    dtype = ">u2" if bit_depth == 16 else np.uint8
    with trace.span("io.png.scanlines"):
        arr = np.ascontiguousarray(samples, dtype=dtype)
        h, w = arr.shape[:2]
        raw = arr.view(np.uint8).reshape(h, -1)
        scanlines = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    with trace.span("io.png.deflate"):
        trace.count("io.png.raw_bytes", scanlines.nbytes)
        idat = zlib.compress(scanlines, 6)
        trace.count("io.png.out_bytes", len(idat))
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, colour, 0, 0, 0)
    return b"".join((_SIGNATURE, _png_chunk(b"IHDR", ihdr),
                     _png_chunk(b"IDAT", idat), _png_chunk(b"IEND", b"")))


def encode_gray_png(pixels: np.ndarray, bit_depth: int = 8) -> bytes:
    """A mono u8 (or u16 at bit_depth 16) plane as PNG bytes in memory."""
    arr = np.asarray(pixels)
    if arr.ndim != 2:
        raise InvalidInput(f"expected 2D grayscale, got {arr.shape}")
    return _png_bytes(arr, 16 if bit_depth == 16 else 8, _GRAY)


def _save(path: str, data: bytes) -> None:
    with trace.span("io.write"), open(path, "wb") as f:
        f.write(data)


def save_gray_png(pixels: np.ndarray, path: str, bit_depth: int = 8) -> None:
    """Save a mono u8 (or u16 at bit_depth 16) plane as PNG."""
    _save(path, encode_gray_png(pixels, bit_depth))


def save_rgb_png(r: np.ndarray, g: np.ndarray, b: np.ndarray, path: str,
                 bit_depth: int = 8) -> None:
    """Save three planes as an RGB PNG (u8, or true u16 at bit_depth 16,
    the reference's Rgb16 export, rgb.rs:49-95)."""
    rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    _save(path, _png_bytes(rgb, 16 if bit_depth == 16 else 8, _RGB))
