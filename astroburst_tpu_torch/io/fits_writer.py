"""FITS writer: mono/RGB, BITPIX 16 (auto BZERO/BSCALE) / -32 / -64
(its own copy of astroburst_tpu/io/fits_writer.py; reference:
src-tauri/src/infra/fits/writer.rs).

BITPIX 16 and -32 planes are encoded by the port's host codec
(``native.encode_be_to_fd``: C++/OpenMP, 4 MB chunks written straight
to the file), as the JAX package's writer routes them; BITPIX -64 is
numpy, as in the JAX package, which has no -64 encoder.
``_encode_plane`` and ``_write_fits_file_plain`` are the numpy encode
and write, the codec's plain versions (tests/test_torch_native.py
holds the files byte-equal). The header has no date card, so the bytes
written are a function of the array and the header alone: the same as
the JAX package's writer (tests/test_torch_io.py compares the files
byte for byte).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from astroburst_tpu_torch.constants import BLOCK_SIZE
from astroburst_tpu_torch.errors import FitsError
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.native import encode_be_to_fd
from astroburst_tpu_torch.runtime import trace

# WCS keyword whitelist (writer.rs:10-19)
WCS_PREFIXES = (
    "CRPIX", "CRVAL", "CDELT", "CTYPE", "CUNIT", "CROTA",
    "CD1_1", "CD1_2", "CD2_1", "CD2_2",
    "PC1_1", "PC1_2", "PC2_1", "PC2_2",
    "LONPOLE", "LATPOLE", "RADESYS", "EQUINOX", "EPOCH",
    "A_ORDER", "B_ORDER", "AP_ORDER", "BP_ORDER",
    "A_", "B_", "AP_", "BP_",
    "PV1_", "PV2_",
    "WCSAXES", "WCSNAME",
)


def is_wcs_card(key: str) -> bool:
    return any(key.startswith(p) for p in WCS_PREFIXES)


def filter_header(header: Optional[HduHeader], copy_wcs: bool,
                  copy_metadata: bool) -> Optional[HduHeader]:
    """Keep WCS cards, metadata cards, both, or none (writer.rs:25-52)."""
    if header is None or (not copy_wcs and not copy_metadata):
        return None
    if copy_wcs and copy_metadata:
        return header.copy()
    if copy_wcs:
        cards = [c for c in header.cards if is_wcs_card(c[0].strip())]
    else:
        cards = [c for c in header.cards if not is_wcs_card(c[0].strip())]
    if not cards:
        return None
    return HduHeader(cards)


def _card(key: str, value: str, comment: str = "") -> bytes:
    s = f"{key:<8}= {value:>20}"
    if comment:
        s = f"{s} / {comment}"
    return s[:80].ljust(80).encode("ascii", "replace")


def _compute_bzero_bscale(arrays: Sequence[np.ndarray]) -> Tuple[float, float]:
    """16-bit auto-scaling over finite values (writer.rs:144-159)."""
    dmin = np.inf
    dmax = -np.inf
    for a in arrays:
        finite = a[np.isfinite(a)]
        if finite.size:
            dmin = min(dmin, float(finite.min()))
            dmax = max(dmax, float(finite.max()))
    if not np.isfinite(dmin) or not np.isfinite(dmax) or abs(dmax - dmin) < 1e-30:
        return 32768.0, 1.0
    bscale = (dmax - dmin) / 65535.0
    bzero = dmin + bscale * 32768.0
    return bzero, bscale


def _encode_plane(data: np.ndarray, bitpix: int, bzero: float,
                  bscale: float) -> np.ndarray:
    """Big-endian encode of one plane, as an array that ``f.write``
    takes without another copy. BITPIX 16 rounds half away from zero
    after clamping, as the reference's Rust ``f64::round``
    (writer.rs:100-119), and writes NaN as 0, as Rust's saturating
    ``as i16`` does (a cast of NaN to an integer is undefined)."""
    flat = np.ascontiguousarray(data, dtype=np.float32).ravel()
    if bitpix == 16:
        physical = (flat.astype(np.float64) - bzero) / bscale
        clamped = np.clip(physical, -32768.0, 32767.0)
        rounded = np.copysign(np.floor(np.abs(clamped) + 0.5), clamped)
        return np.where(np.isnan(rounded), 0.0, rounded).astype(">i2")
    if bitpix == -64:
        return flat.astype(">f8")
    return flat.astype(">f4")


def _pad(n: int) -> bytes:
    rem = n % BLOCK_SIZE
    return b"" if rem == 0 else b"\0" * (BLOCK_SIZE - rem)


_STRUCTURAL_KEYS = ("SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2",
                    "NAXIS3", "BZERO", "BSCALE", "END")


def _header_bytes(dims: Tuple[int, ...], bitpix: int, bzero: float,
                  bscale: float, header: Optional[HduHeader],
                  rgb: bool) -> bytes:
    bitpix_meta = {16: ("16", "16-bit signed integer"),
                   -64: ("-64", "64-bit double")}.get(bitpix, ("-32", "32-bit float"))
    rows, cols = dims
    out: List[bytes] = [
        _card("SIMPLE", "T", "FITS standard"),
        _card("BITPIX", bitpix_meta[0], bitpix_meta[1]),
        _card("NAXIS", "3", "3D RGB cube") if rgb else
        _card("NAXIS", "2", "2D image"),
        _card("NAXIS1", str(cols), "width"),
        _card("NAXIS2", str(rows), "height"),
    ]
    if rgb:
        out.append(_card("NAXIS3", "3", "RGB channels"))
    out.append(_card("BZERO", f"{bzero:.10E}"))
    out.append(_card("BSCALE", f"{bscale:.10E}"))
    if header is not None:
        for k, v in header.cards:
            key = k.strip()
            if key in _STRUCTURAL_KEYS:
                continue
            out.append(_card(key, v))
    out.append(b"END".ljust(80))
    blob = b"".join(out)
    return blob + _pad(len(blob))


def _write_fits_file(path: str, hdr: bytes, planes, bitpix: int,
                     bzero: float, bscale: float) -> None:
    """The header, each plane through the codec's chunked encode to the
    file descriptor (BITPIX 16 and -32), then the pad."""
    if bitpix == -64:
        _write_fits_file_plain(path, hdr, planes, bitpix, bzero, bscale)
        return
    bpp = abs(bitpix) // 8
    total = planes[0].size * bpp * len(planes)
    with open(path, "wb") as f:
        f.write(hdr)
        f.flush()   # the codec writes to the descriptor after it
        for p in planes:
            encode_be_to_fd(p, f.fileno(), bitpix, bzero, bscale)
        f.write(_pad(total))


def _write_fits_file_plain(path: str, hdr: bytes, planes, bitpix: int,
                           bzero: float, bscale: float) -> None:
    bpp = abs(bitpix) // 8
    total = planes[0].size * bpp * len(planes)
    with open(path, "wb") as f:
        f.write(hdr)
        for p in planes:
            f.write(_encode_plane(p, bitpix, bzero, bscale))
        f.write(_pad(total))


def write_fits_mono(path: str, data: np.ndarray,
                    header: Optional[HduHeader] = None,
                    bitpix: int = -32) -> None:
    """Write a mono 2D FITS (writer.rs:240 write_fits_mono_bitpix)."""
    if data.ndim != 2:
        raise FitsError(f"write_fits_mono expects 2D data, got {data.shape}")
    data = np.ascontiguousarray(data, dtype=np.float32)
    if bitpix == 16:
        bzero, bscale = _compute_bzero_bscale([data])
    else:
        bzero, bscale = 0.0, 1.0
    hdr = _header_bytes(data.shape, bitpix, bzero, bscale, header, rgb=False)
    with trace.span("io.write"):
        _write_fits_file(path, hdr, [data], bitpix, bzero, bscale)


def write_fits_rgb(path: str, r: np.ndarray, g: np.ndarray, b: np.ndarray,
                   header: Optional[HduHeader] = None,
                   bitpix: int = -32) -> None:
    """Write an RGB NAXIS=3 FITS (writer.rs:297 write_fits_rgb_bitpix)."""
    if not (r.shape == g.shape == b.shape):
        raise FitsError(
            f"RGB channel dimension mismatch: R={r.shape} G={g.shape} B={b.shape}")
    planes = [np.ascontiguousarray(p, dtype=np.float32) for p in (r, g, b)]
    if bitpix == 16:
        bzero, bscale = _compute_bzero_bscale(planes)
    else:
        bzero, bscale = 0.0, 1.0
    hdr = _header_bytes(planes[0].shape, bitpix, bzero, bscale, header,
                        rgb=True)
    _write_fits_file(path, hdr, planes, bitpix, bzero, bscale)
