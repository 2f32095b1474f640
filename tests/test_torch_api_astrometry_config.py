"""PyTorch port: the astrometry, SPCC and config commands
(``plate_solve_cmd``, ``get_wcs_info``, ``spcc_calibrate_cmd``,
``get_config``, ``update_config``, ``save_api_key``, ``get_api_key``)
end to end against the JAX package's on the CPU, with
``device=torch.device("cpu")``, on FITS files written here from seeded
numpy inputs (at most 2100 × 900). Each test has its own config
directory (``ASTROBURST_CONFIG_DIR``), and astrometry.net is a stand-in
that replaces ``urllib.request.urlopen``: no test contacts a network.

Tolerances, and why:

- the uploaded plane of a file past 2048 px: bit-equal to the numpy
  Catmull-Rom oracle that rounds every f32 product and sum in tap order
  (tests/test_torch_resample.py), and within 2 ulp of its largest
  magnitude of JAX's upload (XLA contracts the taps to FMAs on the CPU:
  ROADMAP C19); the other requests and the response equal to JAX's;
- a file of 2048 px or less: uploaded byte for byte;
- the config files: each package reads what the other wrote, the same
  dicts; the key file's mode 0o600;
- ``get_wcs_info``: the dict equal to JAX's, value for value (host f64
  in both);
- ``spcc_calibrate_cmd``: equal to JAX's given JAX's stars, and within
  the detection's bound end to end (tests/test_torch_astrometry.py).
"""

import json
import os
import stat
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import api as japi
from astroburst_tpu.analysis import star_detection as jsd
from astroburst_tpu.api import helpers as jhelpers
from astroburst_tpu.errors import CacheMiss as JCacheMiss
from astroburst_tpu.errors import InvalidInput as JInvalid
from astroburst_tpu.ops.stats import compute_image_stats as jstats
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.astrometry import spcc as tspcc
from astroburst_tpu_torch.errors import CacheMiss, InvalidInput
from astroburst_tpu_torch.io import extract_image, write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_astrometry import (_record, _unreachable,
                                         astrometry_service, synthetic_field)
from tests.test_torch_resample import _oracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
COMMANDS = ("plate_solve_cmd", "get_wcs_info", "spcc_calibrate_cmd",
            "get_config", "update_config", "save_api_key", "get_api_key")
TAN = [("OBJECT", "'M 81'"), ("CRPIX1", "128.5"), ("CRPIX2", "128.5"),
       ("CRVAL1", "148.888"), ("CRVAL2", "69.065"), ("CD1_1", "-0.0002"),
       ("CD1_2", "1.2E-6"), ("CD2_1", "-1.0E-6"), ("CD2_2", "0.0002"),
       ("CTYPE1", "'RA---TAN'"), ("CTYPE2", "'DEC--TAN'")]
CDELT = [("CRPIX1", "10.5"), ("CRPIX2", "20.25"), ("CRVAL1", "210.8"),
         ("CRVAL2", "54.3"), ("CDELT1", "-2.7777E-4"),
         ("CDELT2", "2.7777E-4"), ("CROTA2", "12.0")]
SIN = [c for c in TAN if not c[0].startswith("CTYPE")] + [
    ("CTYPE1", "'RA---SIN'")]
BOUNDARY = b"--astroburstBoundary"


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """An empty config directory and temporary directory for each test,
    and an empty port cache."""
    monkeypatch.setenv("ASTROBURST_CONFIG_DIR", str(tmp_path / "config"))
    monkeypatch.delenv("ASTROBURST_GAIA_TAP", raising=False)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _fits(tmp_path, name, img, cards=TAN):
    p = str(tmp_path / f"{name}.fits")
    write_fits_mono(p, img, HduHeader(list(cards)))
    return p


def _no_ms(d):
    return {k: v for k, v in d.items() if k != C.RES_ELAPSED_MS}


def _upload_parts(body):
    """(request-json dict, file bytes) of a multipart upload body."""
    head, rest = body.split(b'filename="upload.fits"\r\n'
                            b'Content-Type: application/octet-stream\r\n\r\n')
    assert rest.endswith(b"\r\n" + BOUNDARY + b"--\r\n")
    args = head.split(b'name="request-json"\r\n\r\n')[1].split(b"\r\n")[0]
    return json.loads(args), rest[:-len(BOUNDARY) - 6]


def _plane(tmp_path, blob):
    p = tmp_path / "decoded.fits"
    p.write_bytes(blob)
    return extract_image(str(p)).image


def _solve_both(tmp_path, monkeypatch, path, **hints):
    tapi.save_api_key("k3y", device=CPU)
    seen = _record(monkeypatch, astrometry_service())
    got = tapi.plate_solve_cmd(path, **hints, device=CPU)
    want = japi.plate_solve_cmd(path, **hints)
    assert os.listdir(tmp_path / "tmp") == []
    assert len(seen) == 12
    return got, want, seen[:6], seen[6:]


@pytest.mark.parametrize("hints", [{}, {"ra_hint": 148.9, "dec_hint": 69.1,
                                        "scale_low": 0.5,
                                        "scale_high": 1.0}])
def test_plate_solve_resamples_past_2048_as_jax(tmp_path, monkeypatch,
                                                hints):
    rng = np.random.default_rng(31)
    img = rng.normal(100.0, 5.0, (2100, 900)).astype(np.float32)
    yy, xx = np.mgrid[0:2100, 0:900]
    for cy, cx, a in zip(rng.uniform(0, 2100, 30), rng.uniform(0, 900, 30),
                         rng.uniform(300, 3000, 30)):
        box = (slice(max(int(cy) - 8, 0), int(cy) + 9),
               slice(max(int(cx) - 8, 0), int(cx) + 9))
        img[box] += (a * np.exp(-((yy[box] - cy) ** 2 + (xx[box] - cx) ** 2)
                                / 4.5)).astype(np.float32)
    path = _fits(tmp_path, "tall", img)
    got, want, got_req, want_req = _solve_both(tmp_path, monkeypatch, path,
                                               **hints)
    assert _no_ms(got) == _no_ms(want) and got["success"]
    assert got["ra_center"] == 150.0123 and got["index_name"] == \
        "index-5203-09" and len(got["annotations"]) == 3
    for i in (0, 2, 3, 4, 5):
        assert got_req[i] == want_req[i]
    args_t, blob_t = _upload_parts(got_req[1][1])
    args_j, blob_j = _upload_parts(want_req[1][1])
    assert args_t == args_j and args_t["session"] == "s3ss"
    plane_t, plane_j = _plane(tmp_path, blob_t), _plane(tmp_path, blob_j)
    scale = 2048 / 2100
    shape = (max(int(2100 * scale), 1), max(int(900 * scale), 1))
    assert plane_t.shape == plane_j.shape == shape
    assert np.array_equal(plane_t, _oracle(img, *shape))
    ulp = np.spacing(np.float32(np.abs(plane_t).max()))
    np.testing.assert_allclose(plane_j, plane_t, atol=2 * ulp, rtol=0)


def test_plate_solve_uploads_a_small_file_unchanged(tmp_path, monkeypatch):
    img = np.random.default_rng(4).normal(50, 3, (300, 2048)) \
        .astype(np.float32)
    path = _fits(tmp_path, "small", img)
    got, want, got_req, want_req = _solve_both(tmp_path, monkeypatch, path)
    assert _no_ms(got) == _no_ms(want) and got_req == want_req
    with open(path, "rb") as f:
        assert _upload_parts(got_req[1][1])[1] == f.read()


def test_plate_solve_key_from_config_and_errors_as_jax(tmp_path,
                                                       monkeypatch):
    path = _fits(tmp_path, "s", np.ones((40, 50), np.float32))
    with pytest.raises(Exception) as want:
        japi.plate_solve_cmd(path)
    with pytest.raises(Exception) as got:
        tapi.plate_solve_cmd(path, device=CPU)
    assert str(got.value) == str(want.value) == \
        "astrometry.net API key not configured"
    assert type(got.value).__name__ == "SolveError"
    tapi.update_config("astrometry_api_key", "from-config", device=CPU)
    tapi.update_config("astrometry_api_url", "http://localhost:9/",
                       device=CPU)
    seen = _record(monkeypatch, _unreachable)
    with pytest.raises(Exception) as got:
        tapi.plate_solve_cmd(path, device=CPU)
    with pytest.raises(Exception) as want:
        japi.plate_solve_cmd(path)
    assert str(got.value) == str(want.value)
    assert seen[0] == seen[1] and seen[0][0] == "http://localhost:9/api/login"
    assert b"from-config" in seen[0][1]


def test_config_files_are_shared_with_jax(tmp_path):
    cfg_dir = tmp_path / "config"
    got = tapi.update_config("plate_solve_max_stars", 150, device=CPU)
    tapi.update_config("astrometry_api_url", "http://localhost:9/",
                       device=CPU)
    assert tapi.save_api_key("abc123", device=CPU) == {
        C.RES_SAVED: True, C.RES_SERVICE: "astrometry"}
    assert got["plate_solve_max_stars"] == 150
    assert japi.get_config() == tapi.get_config(device=CPU)
    assert japi.get_config()["astrometry_api_url"] == "http://localhost:9/"
    assert japi.get_api_key() == tapi.get_api_key(device=CPU) == {
        C.RES_SERVICE: "astrometry", "api_key": "abc123"}
    japi.update_config("output_dir", "/data/out")
    japi.save_api_key("zzz", "other")
    assert tapi.get_config(device=CPU) == japi.get_config()
    assert tapi.get_config(device=CPU)["output_dir"] == "/data/out"
    assert tapi.get_api_key("other", device=CPU) == japi.get_api_key("other")
    assert tapi.get_api_key("missing", device=CPU)["api_key"] == ""
    for name in ("astrometry.key", "other.key"):
        assert stat.S_IMODE(os.stat(cfg_dir / name).st_mode) == 0o600
    assert sorted(os.listdir(cfg_dir)) == ["astrometry.key", "config.json",
                                           "other.key"]
    before = (cfg_dir / "config.json").read_bytes()
    with pytest.raises(KeyError) as got:
        tapi.update_config("no_such_field", 1, device=CPU)
    with pytest.raises(KeyError) as want:
        japi.update_config("no_such_field", 1)
    assert str(got.value) == str(want.value)
    assert (cfg_dir / "config.json").read_bytes() == before


def test_config_written_by_each_package_is_byte_equal(tmp_path, monkeypatch):
    for pkg, name in ((tapi, "t"), (japi, "j")):
        monkeypatch.setenv("ASTROBURST_CONFIG_DIR", str(tmp_path / name))
        kw = {"device": CPU} if pkg is tapi else {}
        pkg.update_config("auto_stretch_target_bg", 0.3, **kw)
        pkg.save_api_key(" spaced-key \n", "svc", **kw)
    for f in ("config.json", "svc.key"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


@pytest.mark.parametrize("cards", [TAN, CDELT, SIN],
                         ids=["tan", "cdelt_crota2", "sin"])
def test_get_wcs_info_equals_jax(tmp_path, cards):
    img = np.random.default_rng(9).normal(10, 1, (200, 256)) \
        .astype(np.float32)
    path = _fits(tmp_path, "w", img, cards)
    got = tapi.get_wcs_info(path, device=CPU)
    assert _no_ms(got) == _no_ms(japi.get_wcs_info(path))
    assert set(got) == {C.RES_CENTER_RA, C.RES_CENTER_DEC,
                        "center_formatted", C.RES_PIXEL_SCALE_ARCSEC,
                        C.RES_FOV_W_ARCMIN, C.RES_FOV_H_ARCMIN,
                        C.RES_WCS_PARAMS, C.RES_ELAPSED_MS}


def test_get_wcs_info_without_wcs_raises_as_jax(tmp_path):
    path = _fits(tmp_path, "n", np.ones((20, 20), np.float32),
                 [("OBJECT", "'x'")])
    with pytest.raises(JInvalid) as want:
        japi.get_wcs_info(path)
    with pytest.raises(InvalidInput) as got:
        tapi.get_wcs_info(path, device=CPU)
    assert str(got.value) == str(want.value) == "Missing CRPIX1"


def _seed_composites(planes):
    """The same planes as ORIG and KEY in both packages' caches."""
    tp = [torch.from_numpy(p) for p in planes]
    thelpers.insert_composite_and_orig(*tp, *(compute_image_stats(p)
                                              for p in tp))
    jp = [jnp.asarray(p) for p in planes]
    jhelpers.insert_composite_and_orig(*jp, *(jstats(p) for p in jp))


@pytest.mark.parametrize("given_jax_stars", [True, False])
def test_spcc_command_equals_jax(tmp_path, monkeypatch, given_jax_stars):
    base = synthetic_field(256, 40)
    _seed_composites((base * 1.2, base, base * 0.8))
    path = _fits(tmp_path, "hdr", np.zeros((8, 8), np.float32))
    if given_jax_stars:
        monkeypatch.setattr(tspcc, "detect_stars",
                            lambda lum, sigma, plain=False:
                            jsd.detect_stars(lum.numpy(), sigma))
    got = tapi.spcc_calibrate_cmd(path, min_snr=10.0, device=CPU)
    want = japi.spcc_calibrate_cmd(path, min_snr=10.0)
    assert set(got) == set(want)
    if given_jax_stars:
        assert _no_ms(got) == _no_ms(want)
    else:
        for k in (C.RES_R_FACTOR, C.RES_B_FACTOR, C.RES_AVG_COLOR_INDEX):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
        for k in (C.RES_G_FACTOR, C.RES_STARS_MATCHED, C.RES_STARS_TOTAL,
                  C.RES_WHITE_REF, C.RES_CATALOG_NAME,
                  "is_synthetic_catalog"):
            assert got[k] == want[k], k
    assert got[C.RES_STARS_MATCHED] >= 3
    assert got[C.RES_R_FACTOR] < got[C.RES_B_FACTOR]


def test_spcc_command_errors_as_jax(tmp_path):
    with pytest.raises(JCacheMiss) as want:
        japi.spcc_calibrate_cmd()
    with pytest.raises(CacheMiss) as got:
        tapi.spcc_calibrate_cmd(device=CPU)
    assert str(got.value) == str(want.value)
    base = synthetic_field(256, 40)
    _seed_composites((base, base, base))
    for args in ((), (_fits(tmp_path, "nowcs", np.ones((8, 8), np.float32),
                            [("OBJECT", "'x'")]),)):
        with pytest.raises(JInvalid) as want:
            japi.spcc_calibrate_cmd(*args)
        with pytest.raises(InvalidInput) as got:
            tapi.spcc_calibrate_cmd(*args, device=CPU)
        assert str(got.value) == str(want.value)


def test_commands_without_a_device_raise_where_there_is_no_card(
        tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path = _fits(tmp_path, "a", np.ones((3000, 16), np.float32))
    seen = _record(monkeypatch, astrometry_service())
    calls = {"plate_solve_cmd": (path,), "get_wcs_info": (path,),
             "spcc_calibrate_cmd": (path,), "get_config": (),
             "update_config": ("output_dir", "x"),
             "save_api_key": ("k3y",), "get_api_key": ()}
    assert set(calls) == set(COMMANDS)
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tapi, name)(*args)
    assert GLOBAL_IMAGE_CACHE.keys() == [] and seen == []
    assert not os.path.exists(tmp_path / "config")
    assert os.listdir(tmp_path / "tmp") == []
