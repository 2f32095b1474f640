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

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB = 0, 2   # PNG colour types


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _write_png(path: str, samples: np.ndarray, bit_depth: int,
               colour: int) -> None:
    """Write [H, W] (gray) or [H, W, 3] (RGB) samples at ``bit_depth``
    8 (u8) or 16 (big-endian u16)."""
    dtype = ">u2" if bit_depth == 16 else np.uint8
    arr = np.ascontiguousarray(samples, dtype=dtype)
    h, w = arr.shape[:2]
    raw = arr.view(np.uint8).reshape(h, -1)
    scanlines = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_gray_png(pixels: np.ndarray, path: str, bit_depth: int = 8) -> None:
    """Save a mono u8 (or u16 at bit_depth 16) plane as PNG."""
    arr = np.asarray(pixels)
    if arr.ndim != 2:
        raise InvalidInput(f"expected 2D grayscale, got {arr.shape}")
    if bit_depth == 16:
        _write_png(path, arr.astype(np.uint16), 16, _GRAY)
    else:
        _write_png(path, arr.astype(np.uint8), 8, _GRAY)


def save_rgb_png(r: np.ndarray, g: np.ndarray, b: np.ndarray, path: str,
                 bit_depth: int = 8) -> None:
    """Save three planes as an RGB PNG (u8, or true u16 at bit_depth 16,
    the reference's Rgb16 export, rgb.rs:49-95)."""
    rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    if bit_depth == 16:
        _write_png(path, rgb.astype(np.uint16), 16, _RGB)
    else:
        _write_png(path, rgb.astype(np.uint8), 8, _RGB)
