"""The benchmark's own PNG decoder (zlib and NumPy only).

It decodes 8- and 16-bit gray and RGB images in one or more IDAT
chunks, with every scanline filter of the PNG specification (None,
Sub, Up, Average, Paeth), so it does not depend on the filter the
writer chose.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int64)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                else:
                    raise ValueError(f"PNG filter type {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def decode_png(path_or_bytes) -> np.ndarray:
    """The pixels of a PNG: [H, W] gray or [H, W, 3] RGB, u8 (or u16 at
    bit depth 16)."""
    blob = path_or_bytes
    if not isinstance(blob, (bytes, bytearray)):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + payload) & 0xFFFFFFFF != struct.unpack(
                ">I", blob[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            ihdr = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth not in (8, 16) or colour not in (0, 2) or interlace:
        raise ValueError(f"PNG depth {depth}, colour {colour}, "
                         f"interlace {interlace}")
    chans = 3 if colour == 2 else 1
    bpp = chans * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, w * bpp + 1)
    if rows[:, 0].any():
        px = _unfilter(rows, bpp)
    else:
        px = rows[:, 1:]
    px = np.ascontiguousarray(px).view(">u2" if depth == 16 else np.uint8)
    return px.reshape((h, w) if chans == 1 else (h, w, 3))
