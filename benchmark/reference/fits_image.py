"""The benchmark's own writer and reader of 2-D SCI extensions (NumPy
only), the layout of a JWST i2d file: an empty primary HDU with the
observation's cards, then an ``XTENSION = 'IMAGE'`` HDU named ``SCI``
holding the [H, W] plane, BITPIX -32, big-endian, in 2880-byte blocks.

The reader walks the HDUs and reads the first whose ``EXTNAME`` is
``SCI`` and whose NAXIS is 2; the cards of the primary come before the
extension's in the header it returns, as a reader merges them.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.fits import _DTYPES, BLOCK
from benchmark.reference.fits_cube import _blob, _data_bytes, _header_at
from benchmark.reference.fits_cube import empty_primary


def sci_header(shape, cards=()) -> bytes:
    """The header of an [H, W] BITPIX -32 IMAGE extension named SCI."""
    h, w = shape
    return _blob([("XTENSION", "'IMAGE   '"), ("BITPIX", "-32"),
                  ("NAXIS", "2"), ("NAXIS1", str(w)), ("NAXIS2", str(h)),
                  ("PCOUNT", "0"), ("GCOUNT", "1"), ("EXTNAME", "'SCI'")]
                 + list(cards))


def write_sci_image(path: str, plane: np.ndarray, primary_cards=(),
                    sci_cards=()) -> None:
    """Write ``plane`` [H, W] as the SCI extension behind an empty
    primary HDU."""
    data = np.ascontiguousarray(plane, dtype=">f4")
    with open(path, "wb") as f:
        f.write(empty_primary(primary_cards))
        f.write(sci_header(data.shape, sci_cards))
        data.tofile(f)
        f.write(b"\0" * (-data.nbytes % BLOCK))


def read_sci_image(path: str):
    """(plane f32 [H, W], header dict key -> value text) of the first
    2-D extension named SCI; the primary's cards first, the
    extension's over them."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        offset, merged = 0, {}
        while offset + BLOCK <= size:
            cards, start = _header_at(f, offset)
            head = dict(cards)
            if offset == 0:
                merged.update(head)
            if head.get("EXTNAME") == "SCI" and \
                    int(head.get("NAXIS", "0")) == 2:
                merged.update(head)
                return _decode(f, start, head), merged
            offset = start + _data_bytes(head)
    raise ValueError(f"{path}: no 2-D SCI extension")


def _decode(f, start: int, head: dict) -> np.ndarray:
    h, w = int(head["NAXIS2"]), int(head["NAXIS1"])
    bitpix = int(head["BITPIX"])
    f.seek(start)
    raw = np.fromfile(f, np.dtype(_DTYPES[bitpix]), count=h * w)
    if raw.size != h * w:
        raise ValueError("the plane's data run past the end of the file")
    bscale = float(head.get("BSCALE", "1.0"))
    bzero = float(head.get("BZERO", "0.0"))
    if bitpix == -32 and bscale == 1.0 and bzero == 0.0:
        return raw.astype(np.float32).reshape(h, w)
    return (raw.astype(np.float64) * bscale + bzero).astype(
        np.float32).reshape(h, w)
