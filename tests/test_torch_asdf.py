"""PyTorch port: the ASDF reader (``astroburst_tpu_torch.io.asdf``) against
``astroburst_tpu.io.asdf`` on the hand-built ASDF files of
tests/test_asdf.py (raw, zlib and lz4 blocks, the Roman datamodel path,
the deep search, WCS from the tree and from gWCS steps, multichannel
shapes, the companion FITS, a bad magic), and ASDF frames through the
port's loaders and commands.

Equal means: the same pixels bit for bit, the same metadata, header
cards, WCS and shape, the same error class name. Without PyYAML the
package still imports, and reading an ASDF file raises
ModuleNotFoundError naming PyYAML, with no fallback to a companion
FITS file.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from astroburst_tpu import api as japi
from astroburst_tpu import errors as je
from astroburst_tpu.io import asdf as jasdf
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import errors as te
from astroburst_tpu_torch.api import common as tcommon
from astroburst_tpu_torch.io import asdf as tasdf
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_asdf import BLOCK_MAGIC, lz4_literals, make_asdf, make_block
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _lz4_block(data: bytes) -> bytes:
    payload = lz4_literals(data)
    header = (struct.pack(">I", 0) + b"lz4\0" +
              struct.pack(">Q", len(payload)) +
              struct.pack(">Q", len(payload)) +
              struct.pack(">Q", len(data)) + b"\0" * 16)
    return BLOCK_MAGIC + struct.pack(">H", len(header)) + header + payload


def _case(name, rng):
    """(tree YAML, blocks) of one synthetic file."""
    if name == "raw":
        data = rng.normal(10, 3, (13, 17)).astype(">f4")
        data[2, 3] = np.nan
        return ("!core/asdf-1.1.0\n"
                "data: !core/ndarray-1.0.0\n  source: 0\n"
                "  datatype: float32\n  byteorder: big\n  shape: [13, 17]\n"
                "meta:\n  instrument:\n    name: NIRCAM\n"
                "  exposure: {start_time: 59000.5, groups: [1, 2, 3]}\n"
                "header:\n  TELESCOP: JWST\n"), [make_block(data.tobytes())]
    if name == "zlib":
        data = rng.normal(0, 1, (8, 11)).astype("<f8")
        return ("data:\n  source: 0\n  datatype: float64\n"
                "  byteorder: little\n  shape: [8, 11]\n"), \
            [make_block(data.tobytes(), b"zlib")]
    if name == "lz4":
        data = rng.integers(0, 60000, (6, 9)).astype("<u2")
        return ("data: !core/ndarray-1.0.0 {source: 0, datatype: uint16, "
                "byteorder: little, shape: [6, 9]}"), \
            [_lz4_block(data.tobytes())]
    if name == "roman":
        data = np.arange(6, dtype=">u2").reshape(2, 3)
        return ("roman:\n  data:\n    source: 1\n    datatype: uint16\n"
                "    byteorder: big\n    shape: [2, 3]\n"
                "  meta:\n    telescope: ROMAN\n    exposure: {type: WFI}\n"), \
            [make_block(b"\0" * 8), make_block(data.tobytes())]
    if name == "deep":
        data = rng.normal(5, 1, (4, 5)).astype(">i4")
        return ("products:\n  lvl2:\n"
                "    arr:\n      source: 0\n      datatype: int32\n"
                "      byteorder: big\n      shape: [4, 5]\n"), \
            [make_block(data.tobytes())]
    if name == "wcs":
        data = rng.normal(5, 1, (4, 6)).astype(">f4")
        return ("sci:\n  data:\n    source: 0\n    datatype: float32\n"
                "    byteorder: big\n    shape: [4, 6]\n"
                "wcs:\n  crpix: [2.0, 3.0]\n  crval: [150.0, 30.0]\n"
                "  cdelt: [0.001, 0.002]\n  pc: [[0.9, 0.1], [-0.1, 0.9]]\n"
                "  ctype: [RA---SIN, DEC--SIN]\n"), \
            [make_block(data.tobytes())]
    if name == "gwcs":
        data = rng.normal(5, 1, (3, 4)).astype(">f4")
        return ("data:\n  source: 0\n  datatype: float32\n"
                "  byteorder: big\n  shape: [3, 4]\n"
                "meta:\n  wcs:\n    steps:\n"
                "    - frame: {reference_frame: {lon: 83.8, lat: -5.4}}\n"
                "      transform:\n        transform_type: compose\n"
                "        forward:\n"
                "        - {transform_type: shift, offset: -1024.5}\n"
                "        - {transform_type: scale, factor: 2}\n"), \
            [make_block(data.tobytes())]
    if name == "multichannel":
        data = rng.normal(0, 1, (3, 5, 4)).astype(">f4")
        return ("data:\n  source: 0\n  datatype: float32\n"
                "  byteorder: big\n  shape: [3, 5, 4]\n"), \
            [make_block(data.tobytes())]
    assert name == "channels_last"
    data = rng.normal(0, 1, (6, 7, 3)).astype(">f4")
    return ("image:\n  source: 0\n  datatype: float32\n"
            "  byteorder: big\n  shape: [6, 7, 3]\n"), \
        [make_block(data.tobytes())]


CASES = ["raw", "zlib", "lz4", "roman", "deep", "wcs", "gwcs",
         "multichannel", "channels_last"]


def _write(path, tree, blocks):
    with open(path, "wb") as f:
        f.write(make_asdf(tree, blocks))
    return str(path)


def _assert_same_image(got, want):
    assert (got.width, got.height, got.channels) == \
        (want.width, want.height, want.channels)
    assert got.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)   # NaN == NaN
    assert got.image is got.data
    assert got.metadata == want.metadata
    assert got.header.cards == want.header.cards
    assert (got.wcs is None) == (want.wcs is None)
    if want.wcs is not None:
        assert vars(got.wcs) == vars(want.wcs)


@pytest.mark.parametrize("name", CASES)
def test_load_asdf_image_matches_jax(tmp_path, rng, name):
    p = _write(tmp_path / f"{name}.asdf", *_case(name, rng))
    got, want = tasdf.load_asdf_image(p), jasdf.load_asdf_image(p)
    _assert_same_image(got, want)
    _assert_same_image(tasdf.extract_image_from_asdf(p), want)
    ta, ja = tasdf.open_asdf(p), jasdf.open_asdf(p)
    assert (ta.version, ta.standard_version, ta.tree, ta.blocks) == \
        (ja.version, ja.standard_version, ja.tree, ja.blocks)


def test_companion_fits_fallback_and_bad_magic(tmp_path, rng):
    d = rng.random((6, 6)).astype(np.float32)
    write_fits_mono(str(tmp_path / "x.fits"), d)
    with open(tmp_path / "x.asdf", "wb") as f:
        f.write(b"#ASDF 1.0.0\nnot actually valid yaml blocks")
    got = tasdf.extract_image_from_asdf(str(tmp_path / "x.asdf"))
    want = jasdf.extract_image_from_asdf(str(tmp_path / "x.asdf"))
    np.testing.assert_array_equal(got.data, d)
    assert got.header.cards == want.header.cards
    bad = tmp_path / "bad.asdf"
    bad.write_bytes(b"NOTASDF")
    for mod, err in ((tasdf, te.AsdfError), (jasdf, jasdf.AsdfError)):
        with pytest.raises(err, match="Invalid ASDF magic"):
            mod.open_asdf(str(bad))
        with pytest.raises(err):     # no companion: the AsdfError stands
            mod.extract_image_from_asdf(str(bad))
    assert issubclass(te.AsdfError, te.AstroError)


@pytest.mark.parametrize("src,size", [
    (lz4_literals(bytes(range(256)) * 3), 768),
    (bytes([0x44]) + b"abcd" + bytes([0x04, 0x00]), 12),
    (bytes([0x13]) + b"a" + bytes([0x01, 0x00]), 8),
    (lz4_literals(b"x" * 300), 300),
    (bytes([0x2F]) + b"ab" + bytes([0x02, 0x00]) + bytes([255, 3]), 279),
    (bytes([0x14]) + b"a" + bytes([0x09, 0x00]), 6),     # bad offset
    (lz4_literals(b"abc"), 99),                          # size mismatch
    (bytes([0xF0]), 0),                                  # truncated
])
def test_lz4_block_decompress_matches_jax(src, size):
    try:
        want = jasdf.lz4_block_decompress(src, size)
    except jasdf.AsdfError as e:
        with pytest.raises(te.AsdfError) as got:
            tasdf.lz4_block_decompress(src, size)
        assert str(got.value) == str(e)
        return
    assert tasdf.lz4_block_decompress(src, size) == want


def test_without_pyyaml_the_package_imports_and_asdf_raises(tmp_path, rng):
    """yaml made unimportable: every module of the port imports; an ASDF
    read raises ModuleNotFoundError naming PyYAML, also through the
    command, and never reads the companion FITS beside the file."""
    p = _write(tmp_path / "frame.asdf", *_case("raw", rng))
    write_fits_mono(str(tmp_path / "frame.fits"),
                    np.ones((4, 4), np.float32))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['yaml'] = None\n"
        "import torch\n"
        "import astroburst_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import astroburst_tpu_torch.api as api\n"
        "from astroburst_tpu_torch.errors import AsdfError\n"
        "from astroburst_tpu_torch.io import asdf\n"
        "for fn in (lambda: asdf.extract_image_from_asdf(sys.argv[1]),\n"
        "           lambda: api.process_fits(sys.argv[1], sys.argv[2],\n"
        "                                    device=torch.device('cpu'))):\n"
        "    try:\n"
        "        fn()\n"
        "    except ModuleNotFoundError as e:\n"
        "        assert not isinstance(e, AsdfError)\n"
        "        assert e.name == 'yaml' and 'PyYAML' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error')\n"
        "assert sys.modules['yaml'] is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code, p, str(tmp_path / "o")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_asdf_through_the_decode_buffer(tmp_path, rng):
    """extract_image_resolved copies an ASDF plane into the buffer alloc
    gives it, as io/prefetch.DeviceLoader requires of every loader."""
    p = _write(tmp_path / "a.asdf", *_case("zlib", rng))
    bufs = []

    def alloc(shape):
        bufs.append(np.full(shape, -1.0, np.float32))
        return bufs[-1]

    got = tcommon.extract_image_resolved(p, alloc)
    assert len(bufs) == 1 and got.image is bufs[0]
    np.testing.assert_array_equal(got.image, jasdf.load_asdf_image(p).data)
    assert got.header.get("ASDF_SRC") == "true"
    # a JWST calibration-reference name is refused, as JAX refuses it
    ref = _write(tmp_path / "jwst_flat_0001.asdf", *_case("zlib", rng))
    with pytest.raises(te.InvalidInput, match="calibration"):
        tcommon.extract_image_resolved(ref)
    with pytest.raises(je.InvalidInput, match="calibration"):
        japi.process_fits(ref, str(tmp_path / "j"))


@pytest.mark.parametrize("full", [False, True])
def test_process_fits_of_an_asdf_file_matches_jax(tmp_path, rng, full):
    from tests.test_torch_api_io import _assert_stats_close
    p = _write(tmp_path / "w.asdf", *_case("wcs", rng))
    cmd = "process_fits_full" if full else "process_fits"
    got = getattr(tapi, cmd)(p, str(tmp_path / "t"), device=CPU)
    want = getattr(japi, cmd)(p, str(tmp_path / "j"))
    assert set(got) == set(want)
    assert got["dimensions"] == want["dimensions"] == [6, 4]
    _assert_stats_close(got["stats"], want["stats"])
    if full:
        assert got["header"] == want["header"]
        assert got["header"]["CRVAL1"] == "150.0"
    assert tapi.get_header(p, device=CPU)["cards"] == \
        japi.get_header(p)["cards"]


def test_asdf_frames_through_load_cached_many_and_stack(
        tmp_path, jax_parabola_vertex):
    """Five ASDF frames (bench frames, zlib blocks) through the pooled
    loader and the ``stack`` command, against the JAX command (its phase
    correlation with the parabola vertex, ROADMAP C8)."""
    import bench
    from tests.test_torch_api_stacking import _flips, _header_bytes
    from tests.test_torch_api_io import _assert_stats_close
    from astroburst_tpu_torch.io import extract_image
    frames = bench.make_frames(5, 96, 112, seed=8)
    paths = []
    for k, f in enumerate(frames):
        tree = ("data:\n  source: 0\n  datatype: float32\n"
                "  byteorder: big\n  shape: [96, 112]\n"
                f"meta:\n  frame: {k}\n")
        paths.append(_write(tmp_path / f"f{k}.asdf", tree,
                            [make_block(f.astype(">f4").tobytes(),
                                        b"zlib")]))
    entries = tcommon.load_cached_many(paths, device=CPU)
    for f, e in zip(frames, entries):
        np.testing.assert_array_equal(e.image.numpy(), f)
        assert e.stats is not None
    assert [e.header.get("META_FRAME") for e in entries] == \
        [str(k) for k in range(5)]
    GLOBAL_IMAGE_CACHE.clear()
    got = tapi.stack(paths, str(tmp_path / "t"), device=CPU)
    want = japi.stack(paths, str(tmp_path / "j"))
    assert set(got) == set(want)
    assert got["offsets"] == want["offsets"]
    assert got["frame_count"] == want["frame_count"] == 5
    assert got["dimensions"] == want["dimensions"] == [112, 96]
    img = extract_image(got["fits_path"]).image
    _flips(img, extract_image(want["fits_path"]).image,
           got["rejected_pixels"], want["rejected_pixels"], max_flips=3)
    assert _header_bytes(got["fits_path"]) == _header_bytes(want["fits_path"])
    # the port's stats of its image against JAX's of the same image
    from astroburst_tpu.api.helpers import stats_json_full
    from astroburst_tpu.ops.stats import compute_image_stats
    _assert_stats_close(got["stats"],
                        stats_json_full(compute_image_stats(img)))
