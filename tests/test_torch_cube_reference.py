"""The port's eager cube command (``api.process_cube_cmd`` on the CPU)
against the benchmark's plain reference of it
(``benchmark/reference/cube.py``, the file read by
``benchmark/reference/fits_cube.py``), on seeded small cubes: one case
each for a NaN footprint, all-NaN planes, exact zeros (the median leaves
them out, the mean counts them), a BITPIX 16 cube with BSCALE/BZERO, and
a SCI extension behind an empty primary HDU.

Held exactly: the cube as decoded, the header numbers (dimensions, frame
count, classification, wavelengths), the centre spectrum (NaN kept), the
global statistics and the median collapse (exact order statistics, bit
for bit), and the PNGs of the median and of every sampled frame (the
same f32 operations on the same planes and statistics).

With tolerances, each for its reason:

- the mean collapse: within depth * 2**-24 of the mean of the absolute
  finite values at each pixel. The port sums a column chunk with
  ``torch.sum``, the reference plane by plane in order: the same terms
  in another order, each partial sum rounded once;
- the mean's PNG: within one level, as a value that moved by rounding
  can cross a level's edge.
"""

import os

import numpy as np
import pytest
import torch

from astroburst_tpu_torch import api
from astroburst_tpu_torch.cube import eager as te
from astroburst_tpu_torch.io.prefetch import load_cube
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from benchmark.reference import cube as ref
from benchmark.reference.fits_cube import CubeWriter, read_cube
from benchmark.reference.png import decode_png

CPU = torch.device("cpu")
WAVE = [("CTYPE3", "'WAVE'"), ("CUNIT3", "'um'"), ("CRVAL3", "2.87"),
        ("CDELT3", "0.001171875"), ("CRPIX3", "1.0")]
DEPTH, HW = 40, 24


def _footprint(hw, side, angle_deg):
    c = (hw - 1) / 2.0
    y, x = np.mgrid[0:hw, 0:hw] - c
    a = np.radians(angle_deg)
    u = np.cos(a) * x + np.sin(a) * y
    v = -np.sin(a) * x + np.cos(a) * y
    return (np.abs(u) <= side / 2) & (np.abs(v) <= side / 2)


def _field(seed):
    rng = np.random.default_rng(seed)
    z = np.arange(DEPTH, dtype=np.float64)[:, None, None]
    base = 1.0 + 0.02 * z + rng.normal(0.0, 0.3, (DEPTH, HW, HW))
    base[:, 9:12, 14:17] += 30.0 * np.exp(-(z - 17.0) ** 2 / 3.0)
    return base.astype(np.float32)


def _nan_footprint(seed):
    cube = _field(seed)
    cube[:, ~_footprint(HW, 18, 30.0)] = np.nan
    return cube


def _nan_planes(seed):
    cube = _field(seed)
    cube[10:14] = np.nan          # frames 5 and 6 are sampled inside
    cube[-1, 3, 4] = np.inf
    cube[0, 5, 6] = -np.inf
    return cube


def _zeros(seed):
    cube = _field(seed)
    cube[:, 2, 3] = 0.0           # all zero: median 0, mean 0
    cube[: DEPTH // 2, 7, 7] = 0.0
    cube[np.random.default_rng(seed + 1).random(cube.shape) < 0.05] = 0.0
    cube[:, HW // 2, HW // 2 - 1] = -0.0
    return cube


CASES = {
    "nan_footprint": (_nan_footprint, {}),
    "all_nan_planes": (_nan_planes, {}),
    "exact_zeros": (_zeros, {}),
    "bitpix16_bscale_bzero": (_field, {"bitpix": 16}),
    "sci_extension": (_nan_footprint, {"primary_cards": [
        ("TELESCOP", "'JWST'"), ("INSTRUME", "'NIRSPEC'")]}),
}


def write_case(tmp_path, name, seed):
    make, kw = CASES[name]
    cube = make(seed)
    path = str(tmp_path / f"{name}.fits")
    cards = list(WAVE) + [("BUNIT", "'MJy/sr'")]
    if kw.get("bitpix") == 16:
        raw = np.round((np.nan_to_num(cube) - 5.0) / 0.37).astype(np.int16)
        cards += [("BSCALE", "0.37"), ("BZERO", "5.0")]
        with CubeWriter(path, cube.shape, cards, bitpix=16) as w:
            w.write(raw)
    else:
        with CubeWriter(path, cube.shape, cards,
                        kw.get("primary_cards")) as w:
            w.write(cube)
    return path


def _bits(t):
    return torch.as_tensor(t, dtype=torch.float32).contiguous().view(
        torch.int32)


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


@pytest.mark.parametrize("case", list(CASES))
def test_process_cube_cmd_matches_the_plain_reference(tmp_path, case):
    path = write_case(tmp_path, case, 7 + list(CASES).index(case))
    got = api.process_cube_cmd(path, str(tmp_path / "out"), device=CPU)
    host, header = read_cube(path)
    want = ref.process_cube(torch.from_numpy(host), header)
    _, cube = load_cube(path, CPU)
    assert torch.equal(_bits(cube), _bits(torch.from_numpy(host)))

    for key, theirs in (("dimensions", "dimensions"),
                        ("frame_count", "frame_count"),
                        ("wavelengths", "wavelengths"),
                        ("spectral_classification", "classification")):
        assert got[key] == want[theirs], key
    assert got["frame_count"] == len(range(0, DEPTH, DEPTH // 16))
    assert torch.equal(_bits(got["center_spectrum"]),
                       _bits(want["center_spectrum"]))

    g = te.compute_global_stats(cube)
    assert [float(getattr(g, k)).hex() for k in want["stats"]] == \
        [float(v).hex() for v in want["stats"].values()]
    assert torch.equal(_bits(te.collapse_median(cube)),
                       _bits(want["median"]))
    np.testing.assert_array_equal(decode_png(got["collapsed_median_path"]),
                                  want["median_u8"].numpy())
    frames = sorted(os.listdir(got["frames_dir"]))
    assert len(frames) == len(want["frames_u8"])
    for name, u8 in zip(frames, want["frames_u8"]):
        np.testing.assert_array_equal(
            decode_png(os.path.join(got["frames_dir"], name)), u8.numpy())

    mean = te.collapse_mean(cube)
    finite = torch.isfinite(cube)
    cnt = finite.sum(0).clamp(min=1)
    scale = torch.where(finite, cube.abs(), 0.0).sum(0) / cnt
    assert ((mean - want["mean"]).abs() <= DEPTH * 2.0 ** -24 * scale).all()
    a = decode_png(got["collapsed_path"]).astype(np.int16)
    assert np.abs(a - want["mean_u8"].numpy()).max() <= 1
