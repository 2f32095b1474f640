"""The benchmark's own FITS writer and reader (NumPy only).

They cover what the benchmark's files and the port's outputs use: one
primary HDU, NAXIS 2, BITPIX -32 (and 16/8/32/-64 on read, with
BSCALE/BZERO), 2880-byte blocks of 80-character cards. A card's value
is read as the FITS standard writes it: a quoted string keeps its
inner text without trailing blanks, any other value ends at an inline
``/`` comment.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80
_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def _card(key: str, value: str) -> bytes:
    text = f"{key:<8}= {value:>20}"
    if len(text) > CARD:
        raise ValueError(f"card {key} is longer than {CARD} characters")
    return text.ljust(CARD).encode("ascii")


def header_bytes(shape, cards=()) -> bytes:
    """A primary header for an [H, W] BITPIX -32 plane with ``cards``
    ((key, value text) pairs, strings already quoted)."""
    h, w = shape
    head = [_card("SIMPLE", "T"), _card("BITPIX", "-32"),
            _card("NAXIS", "2"), _card("NAXIS1", str(w)),
            _card("NAXIS2", str(h))]
    head += [_card(k, v) for k, v in cards]
    blob = b"".join(head) + b"END".ljust(CARD)
    return blob + b" " * (-len(blob) % BLOCK)


def write_fits(path: str, plane: np.ndarray, cards=()) -> None:
    """Write ``plane`` [H, W] as a BITPIX -32 primary HDU."""
    data = np.ascontiguousarray(plane, dtype=">f4")
    with open(path, "wb") as f:
        f.write(header_bytes(data.shape, cards))
        data.tofile(f)
        f.write(b"\0" * (-data.nbytes % BLOCK))


def card_value(raw: str) -> str:
    text = raw.strip()
    if text.startswith("'"):
        end = text.find("'", 1)
        if end != -1:
            return text[1:end].rstrip()
    slash = text.find("/")
    return text[:slash].strip() if slash != -1 else text


def read_header(blob: bytes, offset: int = 0):
    """(cards as (key, value) pairs, offset of the data) of the header
    that starts at ``offset``."""
    cards = []
    pos = offset
    while True:
        if pos + BLOCK > len(blob):
            raise ValueError("FITS header has no END card")
        block = blob[pos:pos + BLOCK]
        pos += BLOCK
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD]
            key = card[:8].decode("ascii", "replace").strip()
            if key == "END":
                return cards, pos
            if card[8:10] == b"= ":
                cards.append((key, card_value(
                    card[10:].decode("ascii", "replace"))))


def read_fits(path: str):
    """(plane f32 [H, W], header dict key -> value text) of the primary
    HDU of a 2-D FITS file."""
    with open(path, "rb") as f:
        blob = f.read()
    cards, start = read_header(blob)
    head = dict(cards)
    bitpix = int(head["BITPIX"])
    if int(head["NAXIS"]) != 2:
        raise ValueError(f"{path}: NAXIS {head['NAXIS']}, expected 2")
    w, h = int(head["NAXIS1"]), int(head["NAXIS2"])
    dtype = np.dtype(_DTYPES[bitpix])
    raw = np.frombuffer(blob, dtype, count=h * w, offset=start)
    plane = raw.astype(np.float64 if bitpix == -64 else np.float32)
    bscale = float(head.get("BSCALE", "1.0"))
    bzero = float(head.get("BZERO", "0.0"))
    if bitpix > 0 or bscale != 1.0 or bzero != 0.0:
        plane = plane * bscale + bzero
    return plane.astype(np.float32).reshape(h, w), head
