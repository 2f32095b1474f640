"""Memory-mapped FITS reader (its own copy of the 2-D image and RGB-FITS
paths of astroburst_tpu/io/fits_reader.py; reference:
src-tauri/src/infra/fits/reader.rs).

Header parse in 2880-byte blocks, multi-HDU scan, SCI-extension
auto-select, primary ⊕ extension header merge, the BITPIX
{8, 16, 32, -32, -64} big-endian decode with BSCALE/BZERO, and the
NAXIS3 ∈ [3, 4] RGB-FITS planes, and 3-D cubes (``extract_cube``: the
first HDU with NAXIS = 3 and NAXIS3 > 1, reader.rs:513-557). The decode
runs the port's host codec (``native``, C++/OpenMP) over a memory map:
BITPIX -32 with the identity scaling is one byte-swapping copy; any
other case runs the per-pixel f64 math of the reference, then rounds to
f32. ``decode_pixels_plain`` is the same decode in numpy, bit for bit
(tests/test_torch_native.py).

``extract_image`` takes an optional ``alloc(shape)`` that returns the
f32 array the pixels are decoded into, so a caller can decode straight
into pinned host memory (io/prefetch.py) without a second copy.
"""

from __future__ import annotations

import mmap as _mmap
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from astroburst_tpu_torch.constants import BLOCK_SIZE, CARD_SIZE
from astroburst_tpu_torch.errors import FitsError
from astroburst_tpu_torch.io.header import (HduHeader, HduInfo,
                                            extract_header_value)
from astroburst_tpu_torch.native import checked_target as _checked
from astroburst_tpu_torch.native import decode_pixels_native
from astroburst_tpu_torch.runtime import trace

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

Alloc = Callable[[Tuple[int, ...]], np.ndarray]


def decode_pixels(raw, bitpix: int, bscale: float, bzero: float,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode big-endian FITS data bytes to float32 with BSCALE/BZERO
    through the host codec (``native``, on every core), into ``out`` (a
    C-contiguous f32 array of as many elements) when it is given. BITPIX
    -32 with bscale 1 and bzero 0 is a pure byteswap (reader.rs:42-101
    keeps the same shortcut); otherwise the values go through f64, as
    the reference's per-pixel math does."""
    if bitpix not in _BITPIX_DTYPES:
        raise FitsError(f"Unsupported BITPIX {bitpix}")
    with trace.span("io.decode"):
        px = decode_pixels_native(raw, bitpix, bscale, bzero, out)
        trace.count("io.decode_bytes", px.nbytes)
    return px


def decode_pixels_plain(raw, bitpix: int, bscale: float, bzero: float,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """``decode_pixels`` in numpy, the codec's plain version: the bits
    it must give."""
    dt = _BITPIX_DTYPES.get(bitpix)
    if dt is None:
        raise FitsError(f"Unsupported BITPIX {bitpix}")
    n = len(raw) // dt.itemsize
    out = np.empty(n, np.float32) if out is None else _checked(out, n)
    vals = np.frombuffer(raw, dtype=dt, count=n)
    flat = out.reshape(-1)
    if bitpix == -32 and bscale == 1.0 and bzero == 0.0:
        np.copyto(flat, vals)
        return out
    phys = vals.astype(np.float64)
    if bscale != 1.0:
        phys *= bscale
    if bzero != 0.0:
        phys += bzero
    np.copyto(flat, phys, casting="same_kind")
    return out


def _scaling(header: HduHeader) -> Tuple[float, float]:
    bzero = header.get_f64("BZERO")
    bscale = header.get_f64("BSCALE")
    return (bzero if bzero is not None else 0.0,
            bscale if bscale is not None else 1.0)


@dataclass
class ParsedHdu:
    header: HduHeader
    header_start: int
    data_start: int
    next_hdu_offset: int


def parse_header_at(buf, offset: int) -> ParsedHdu:
    """Parse one header starting at `offset` (80-char cards, END card)."""
    cards: List[Tuple[str, str]] = []
    pos = offset
    end_found = False
    n = len(buf)
    while not end_found:
        if pos + BLOCK_SIZE > n:
            raise FitsError(
                f"Unexpected end of file while reading header at offset {offset}")
        block = bytes(buf[pos:pos + BLOCK_SIZE])
        pos += BLOCK_SIZE
        for ci in range(0, BLOCK_SIZE, CARD_SIZE):
            card = block[ci:ci + CARD_SIZE]
            keyword = card[0:8].decode("ascii", "replace").strip()
            if keyword == "END":
                end_found = True
                break
            if card[8:10] != b"= ":
                continue
            value = extract_header_value(card[10:].decode("ascii", "replace"))
            cards.append((keyword, value))
    header = HduHeader(cards)
    data_start = pos
    return ParsedHdu(header, offset, data_start,
                     data_start + header.padded_data_bytes())


@dataclass
class ScannedHdu:
    info: HduInfo
    header: HduHeader


def scan_all_hdus(buf) -> List[ScannedHdu]:
    hdus: List[ScannedHdu] = []
    offset = 0
    idx = 0
    n = len(buf)
    while offset < n:
        if offset + BLOCK_SIZE > n:
            if not hdus:
                raise FitsError("FITS file too small to contain a valid header")
            break
        try:
            parsed = parse_header_at(buf, offset)
        except FitsError:
            if hdus:
                break
            raise
        h = parsed.header
        naxis = h.get_i64("NAXIS") or 0
        naxis1 = h.get_i64("NAXIS1") or 0
        naxis2 = h.get_i64("NAXIS2") or 0
        naxis3 = h.get_i64("NAXIS3") or 0
        bitpix = h.get_i64("BITPIX") or 0
        has_data = naxis >= 2 and naxis1 > 1 and naxis2 > 1
        hdus.append(ScannedHdu(
            HduInfo(index=idx, extname=h.get("EXTNAME"),
                    extver=h.get_i64("EXTVER"), naxis=naxis, naxis1=naxis1,
                    naxis2=naxis2, naxis3=naxis3, bitpix=bitpix,
                    has_data=has_data, header_start=parsed.header_start,
                    data_start=parsed.data_start),
            h))
        offset = parsed.next_hdu_offset
        idx += 1
    return hdus


def select_best_image_hdu(hdus: List[ScannedHdu]) -> Optional[int]:
    """SCI extension wins; else first data extension; else primary
    (reader.rs:274-301)."""
    if len(hdus) == 1 and hdus[0].info.has_data:
        return 0
    for i, h in enumerate(hdus):
        name = h.info.extname
        if name and name.upper() == "SCI" and h.info.has_data:
            return i
    for i, h in enumerate(hdus):
        if i == 0:
            continue
        if h.info.has_data:
            return i
    if hdus and hdus[0].info.has_data:
        return 0
    return None


def build_merged_header(hdus: List[ScannedHdu], selected_idx: int) -> HduHeader:
    if selected_idx == 0 or len(hdus) == 1:
        return hdus[selected_idx].header.copy()
    return hdus[0].header.merge_with(hdus[selected_idx].header)


def _extract_plane(buf, hdu: ScannedHdu, plane: int = 0,
                   alloc: Optional[Alloc] = None) -> np.ndarray:
    h = hdu.header
    naxis1 = h.get_i64("NAXIS1") or 0
    naxis2 = h.get_i64("NAXIS2") or 0
    bitpix = h.get_i64("BITPIX")
    if bitpix is None:
        raise FitsError("Missing BITPIX")
    bpp = abs(bitpix) // 8
    plane_bytes = naxis1 * naxis2 * bpp
    start = hdu.info.data_start + plane * plane_bytes
    end = start + plane_bytes
    if end > len(buf):
        raise FitsError("Image data exceeds file size")
    bzero, bscale = _scaling(h)
    out = np.empty((naxis2, naxis1), np.float32) if alloc is None else \
        _checked(alloc((naxis2, naxis1)), naxis1 * naxis2)
    # memoryview slice: zero-copy on the mmap (mmap[a:b] would copy)
    return decode_pixels(memoryview(buf)[start:end], bitpix, bscale, bzero,
                         out)


@dataclass
class FitsImage:
    header: HduHeader
    image: np.ndarray  # float32 [H, W]
    is_mef: bool
    selected_extension: Optional[str]
    extension_count: int
    extensions: List[HduInfo] = field(default_factory=list)


@dataclass
class FitsRgb:
    header: HduHeader
    r: np.ndarray
    g: np.ndarray
    b: np.ndarray
    is_mef: bool
    selected_extension: Optional[str]
    extension_count: int
    extensions: List[HduInfo] = field(default_factory=list)


class _Mapped:
    """Context manager yielding a read-only memoryview of the file."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._mm = None

    def __enter__(self):
        self._f = open(self.path, "rb")
        try:
            self._mm = _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):
            # empty or unmappable file: fall back to bytes
            self._f.seek(0)
            return self._f.read()
        return self._mm

    def __exit__(self, *exc):
        if self._mm is not None:
            self._mm.close()
        if self._f is not None:
            self._f.close()
        return False


def _selected_name(hdus: List[ScannedHdu], idx: int) -> Optional[str]:
    if idx == 0:
        return None
    return hdus[idx].info.extname or f"HDU {idx}"


def extract_image(path: str, alloc: Optional[Alloc] = None) -> FitsImage:
    """Load the best 2D image HDU (SCI auto-select) from a FITS file,
    decoded into ``alloc((rows, cols))`` when it is given."""
    with _Mapped(path) as buf:
        hdus = scan_all_hdus(buf)
        if not hdus:
            raise FitsError("No HDUs found in FITS file")
        sel = select_best_image_hdu(hdus)
        if sel is None:
            raise FitsError("No 2D image block found in any HDU")
        image = _extract_plane(buf, hdus[sel], alloc=alloc)
        return FitsImage(
            header=build_merged_header(hdus, sel),
            image=image,
            is_mef=len(hdus) > 1,
            selected_extension=_selected_name(hdus, sel),
            extension_count=len(hdus),
            extensions=[h.info for h in hdus],
        )



def extract_image_by_index(path: str, hdu_index: int) -> FitsImage:
    with _Mapped(path) as buf:
        hdus = scan_all_hdus(buf)
        if hdu_index >= len(hdus):
            raise FitsError(
                f"HDU index {hdu_index} out of range (file has {len(hdus)} HDUs)")
        if not hdus[hdu_index].info.has_data:
            raise FitsError(f"HDU {hdu_index} has no image data")
        image = _extract_plane(buf, hdus[hdu_index])
        return FitsImage(
            header=build_merged_header(hdus, hdu_index),
            image=image,
            is_mef=len(hdus) > 1,
            selected_extension=_selected_name(hdus, hdu_index),
            extension_count=len(hdus),
            extensions=[h.info for h in hdus],
        )


def try_extract_rgb(path: str) -> Optional[FitsRgb]:
    """If the selected HDU is NAXIS=3 with 3-4 planes, decode RGB planes
    (reader.rs:435-505); else None."""
    with _Mapped(path) as buf:
        hdus = scan_all_hdus(buf)
        if not hdus:
            raise FitsError("No HDUs found in FITS file")
        sel = select_best_image_hdu(hdus)
        if sel is None:
            return None
        h = hdus[sel].header
        naxis = h.get_i64("NAXIS") or 0
        naxis3 = h.get_i64("NAXIS3") or 0
        if naxis != 3 or naxis3 < 3 or naxis3 > 4:
            return None
        planes = [_extract_plane(buf, hdus[sel], p) for p in range(3)]
        return FitsRgb(
            header=build_merged_header(hdus, sel),
            r=planes[0], g=planes[1], b=planes[2],
            is_mef=len(hdus) > 1,
            selected_extension=_selected_name(hdus, sel),
            extension_count=len(hdus),
            extensions=[h2.info for h2 in hdus],
        )


@dataclass
class FitsCube:
    header: HduHeader
    cube: np.ndarray  # float32 [C, H, W]


@dataclass
class CubeHdu:
    """Where a cube's pixels lie in its file, and how they decode."""
    header: HduHeader
    data_start: int
    naxis1: int
    naxis2: int
    naxis3: int
    bitpix: int
    bzero: float
    bscale: float

    @property
    def frame_bytes(self) -> int:
        return self.naxis1 * self.naxis2 * (abs(self.bitpix) // 8)


def find_cube_hdu(buf) -> CubeHdu:
    """The first HDU with NAXIS = 3 and NAXIS3 > 1 (reader.rs:513-557);
    FitsError when there is none."""
    offset = 0
    n = len(buf)
    while offset + BLOCK_SIZE <= n:
        parsed = parse_header_at(buf, offset)
        h = parsed.header
        if (h.get_i64("NAXIS") or 0) == 3 and (h.get_i64("NAXIS3") or 0) > 1:
            bitpix = h.get_i64("BITPIX")
            if bitpix is None:
                raise FitsError("Missing BITPIX in cube HDU")
            bzero, bscale = _scaling(h)
            return CubeHdu(h, parsed.data_start, h.get_i64("NAXIS1") or 0,
                           h.get_i64("NAXIS2") or 0, h.get_i64("NAXIS3"),
                           bitpix, bzero, bscale)
        offset = parsed.next_hdu_offset
    raise FitsError("No 3D data block found")


def extract_cube(path: str) -> FitsCube:
    """The first NAXIS=3 HDU as a [C, H, W] f32 cube."""
    with _Mapped(path) as buf:
        hdu = find_cube_hdu(buf)
        total = hdu.frame_bytes * hdu.naxis3
        if hdu.data_start + total > len(buf):
            raise FitsError("Cube data exceeds file size")
        pixels = decode_pixels(
            memoryview(buf)[hdu.data_start:hdu.data_start + total],
            hdu.bitpix, hdu.bscale, hdu.bzero)
        return FitsCube(hdu.header, pixels.reshape(hdu.naxis3, hdu.naxis2,
                                                   hdu.naxis1))


def list_extensions(path: str) -> List[HduInfo]:
    with _Mapped(path) as buf:
        return [h.info for h in scan_all_hdus(buf)]
