"""The benchmark's own FITS writer and reader and its PNG decoder, against
each other and against the port's writer, reader and encoder."""

import struct
import zlib

import numpy as np
import pytest

from benchmark.reference.fits import read_fits, write_fits
from benchmark.reference.png import decode_png


def _plane(h=37, w=53, seed=3):
    x = np.random.default_rng(seed).normal(100, 20, (h, w)).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2], x[3, 3] = np.nan, np.inf, -0.0, 1e-40
    return x


def test_fits_round_trip_keeps_every_bit(tmp_path):
    x = _plane()
    p = str(tmp_path / "a.fits")
    write_fits(p, x, [("OBJECT", "'M 51'"), ("EXPTIME", "300.0")])
    y, head = read_fits(p)
    assert y.view(np.uint32).tolist() == x.view(np.uint32).tolist()
    assert head["OBJECT"] == "M 51" and head["EXPTIME"] == "300.0"
    assert head["NAXIS1"] == "53" and head["NAXIS2"] == "37"
    with open(p, "rb") as f:
        assert len(f.read()) % 2880 == 0


def test_port_reads_our_files_and_we_read_its(tmp_path):
    import torch
    from astroburst_tpu_torch.io import write_fits_mono
    from astroburst_tpu_torch.io.fits_reader import extract_image
    x = _plane()
    ours = str(tmp_path / "ours.fits")
    write_fits(ours, x, [("TELESCOP", "'JWST'")])
    got = extract_image(ours)
    assert got.image.view(np.uint32).tolist() == x.view(np.uint32).tolist()
    assert dict(got.header.index) == read_fits(ours)[1]
    theirs = str(tmp_path / "theirs.fits")
    write_fits_mono(theirs, x, got.header)
    y, _ = read_fits(theirs)
    assert torch.equal(torch.from_numpy(y).view(torch.int32),
                       torch.from_numpy(x).view(torch.int32))


@pytest.mark.parametrize("rgb", [False, True])
def test_png_decode_of_the_port_encoder(tmp_path, rgb):
    from astroburst_tpu_torch.io import png
    rng = np.random.default_rng(5)
    if rgb:
        r, g, b = (rng.integers(0, 256, (17, 29), dtype=np.uint8)
                   for _ in range(3))
        path = str(tmp_path / "c.png")
        png.save_rgb_png(r, g, b, path)
        assert np.array_equal(decode_png(path), np.stack([r, g, b], -1))
    else:
        x = rng.integers(0, 256, (17, 29), dtype=np.uint8)
        assert np.array_equal(decode_png(png.encode_gray_png(x)), x)


def _filtered_png(px: np.ndarray, ftype: int) -> bytes:
    """A gray u8 PNG whose every scanline uses filter ``ftype``."""
    h, w = px.shape
    raw = px.astype(np.int64)
    rows = []
    for y in range(h):
        prev = raw[y - 1] if y else np.zeros(w, np.int64)
        out = []
        for x in range(w):
            a = raw[y, x - 1] if x else 0
            b = prev[x]
            c = prev[x - 1] if x else 0
            if ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((raw[y, x] - pred) & 0xFF)
        rows.append(bytes([ftype] + out))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
def test_png_decode_of_every_filter(ftype):
    x = np.random.default_rng(ftype).integers(0, 256, (9, 13), dtype=np.uint8)
    assert np.array_equal(decode_png(_filtered_png(x, ftype)), x)
