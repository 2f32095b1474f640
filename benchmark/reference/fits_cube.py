"""The benchmark's own writer and reader of FITS cubes (NumPy only).

A cube is written either as a primary HDU or, as a JWST s3d file holds
it, as an ``XTENSION = 'IMAGE'`` extension named ``SCI`` behind a
primary HDU with no data. The samples are BITPIX -32, or BITPIX 16 with
``BSCALE``/``BZERO`` cards, big-endian, in 2880-byte blocks.

The reader takes the first HDU with NAXIS = 3 and NAXIS3 > 1, skipping
the data of the HDUs before it. BITPIX -32 with no scaling is read as
it is stored; any other BITPIX or scaling goes through float64
(physical = raw * BSCALE + BZERO, as the FITS standard defines it)
before it is rounded to float32.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.fits import _DTYPES, BLOCK, CARD, _card, read_header


def _blob(cards) -> bytes:
    blob = b"".join(_card(k, v) for k, v in cards) + b"END".ljust(CARD)
    return blob + b" " * (-len(blob) % BLOCK)


def cube_header(shape, bitpix: int = -32, cards=(), extension=False
                ) -> bytes:
    """The header of a [D, H, W] cube HDU with ``cards`` ((key, value
    text) pairs, strings already quoted): a primary HDU, or with
    ``extension`` an IMAGE extension named SCI."""
    d, h, w = shape
    first = ([("XTENSION", "'IMAGE   '")] if extension
             else [("SIMPLE", "T")])
    head = first + [("BITPIX", str(bitpix)), ("NAXIS", "3"),
                    ("NAXIS1", str(w)), ("NAXIS2", str(h)),
                    ("NAXIS3", str(d))]
    if extension:
        head += [("PCOUNT", "0"), ("GCOUNT", "1"), ("EXTNAME", "'SCI'")]
    return _blob(head + list(cards))


def empty_primary(cards=()) -> bytes:
    """A primary HDU with no data that announces extensions."""
    return _blob([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"),
                  ("EXTEND", "T")] + list(cards))


class CubeWriter:
    """Writes a cube file plane block by plane block::

        with CubeWriter(path, (d, h, w), sci_cards, primary_cards) as w:
            for block in blocks:        # [k, H, W] arrays in plane order
                w.write(block)

    ``primary_cards`` None writes the cube as the primary HDU; a list
    (even empty) writes an empty primary with those cards and the cube
    as the SCI extension."""

    def __init__(self, path: str, shape, sci_cards=(), primary_cards=None,
                 bitpix: int = -32):
        self.shape, self.bitpix = tuple(shape), bitpix
        self.dtype = np.dtype(_DTYPES[bitpix])
        self.f = open(path, "wb")
        if primary_cards is not None:
            self.f.write(empty_primary(primary_cards))
        self.f.write(cube_header(self.shape, bitpix, sci_cards,
                                 extension=primary_cards is not None))
        self.written = 0

    def write(self, block: np.ndarray) -> None:
        data = np.ascontiguousarray(block, dtype=self.dtype)
        data.tofile(self.f)
        self.written += data.nbytes

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is None:
                want = int(np.prod(self.shape)) * self.dtype.itemsize
                if self.written != want:
                    raise ValueError(f"wrote {self.written} bytes of "
                                     f"samples, the header says {want}")
                self.f.write(b"\0" * (-self.written % BLOCK))
        finally:
            self.f.close()
        return False


def _data_bytes(head: dict) -> int:
    naxis = int(head.get("NAXIS", "0"))
    if naxis == 0:
        return 0
    n = abs(int(head["BITPIX"])) // 8
    for i in range(1, naxis + 1):
        n *= int(head.get(f"NAXIS{i}", "1"))
    n = n * int(head.get("GCOUNT", "1")) + int(head.get("PCOUNT", "0"))
    return n + (-n % BLOCK)


def _header_at(f, offset: int):
    """(cards, offset of the data) of the header that starts at
    ``offset``, read a block at a time."""
    f.seek(offset)
    blob = b""
    while True:
        more = f.read(BLOCK)
        if len(more) < BLOCK:
            raise ValueError("a FITS header has no END card")
        blob += more
        try:
            cards, end = read_header(blob)
        except ValueError:
            continue
        return cards, offset + end


def read_cube(path: str):
    """(cube f32 [D, H, W], the cube HDU's header dict key -> value
    text) of the first HDU with NAXIS = 3 and NAXIS3 > 1."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        offset = 0
        while offset + BLOCK <= size:
            cards, start = _header_at(f, offset)
            head = dict(cards)
            if int(head.get("NAXIS", "0")) == 3 and \
                    int(head.get("NAXIS3", "0")) > 1:
                return _decode(f, start, head), head
            offset = start + _data_bytes(head)
    raise ValueError(f"{path}: no HDU with NAXIS = 3")


def _decode(f, start: int, head: dict) -> np.ndarray:
    d, h, w = (int(head[f"NAXIS{i}"]) for i in (3, 2, 1))
    bitpix = int(head["BITPIX"])
    f.seek(start)
    raw = np.fromfile(f, np.dtype(_DTYPES[bitpix]), count=d * h * w)
    if raw.size != d * h * w:
        raise ValueError("the cube's data run past the end of the file")
    bscale = float(head.get("BSCALE", "1.0"))
    bzero = float(head.get("BZERO", "0.0"))
    if bitpix == -32 and bscale == 1.0 and bzero == 0.0:
        return raw.astype(np.float32).reshape(d, h, w)
    phys = raw.astype(np.float64)
    if bscale != 1.0:       # an identity step is skipped: -0.0 stays -0.0
        phys *= bscale
    if bzero != 0.0:
        phys += bzero
    return phys.astype(np.float32).reshape(d, h, w)
