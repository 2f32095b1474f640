"""PyTorch port: IFU cubes (``io/fits_reader.extract_cube``,
``io/prefetch.load_cube``, ``cube/eager.py``, ``cube/lazy.py``) against
the JAX package's on the CPU, on seeded numpy cubes of 8 × 24 × 24 and
40 × 16 × 16, BITPIX −32 and 16 (BSCALE 0.37, BZERO 32768: the JAX
package's native decoder contracts raw · bscale + bzero to an FMA, so
where the two terms cancel to ~0 it keeps a residue of ~1e-16 that the
port's f64 multiply-then-add does not), with NaN, ±inf and zero pixels.

Tolerances, and why:

- decoded cubes, frames, spectra, the lazy collapses, the
  classification and the wavelength axis bit-equal (the same host
  code; the lazy mean accumulates on the host in f64, as JAX does);
- ``collapse_median`` bit-equal (a sort over the spectral axis read at
  cnt // 2 in both packages), also through several column chunks;
  ``collapse_mean`` within 1e-6 relative (f32 sums in another order);
- the global stats bit-equal to an ``np.partition`` oracle (exact order
  statistics at the f32 ranks), and within 2·range/8⁶ of JAX's
  compare-count ranks (ROADMAP C21), sigma through the same MAD bound;
- the asinh normalize within 4 ulp of 3 of JAX's given the same stats
  (torch's and XLA's asinh differ by a few ulp: C25), and the u8
  preview within one level, equal where the scaled value lies more than
  1e-3 of a level from an integer.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import io as jio
from astroburst_tpu.cube import eager as je
from astroburst_tpu.cube.lazy import LazyCube as JLazy
from astroburst_tpu.io.header import HduHeader as JHeader
from astroburst_tpu_torch.cube import eager as te
from astroburst_tpu_torch.cube.lazy import LazyCube as TLazy
from astroburst_tpu_torch.io import extract_cube
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.io.prefetch import load_cube
from tests.test_fits_io import make_fits

japi_cube = importlib.import_module("astroburst_tpu.api.cube")
tapi_cube = importlib.import_module("astroburst_tpu_torch.api.cube")

torch.set_num_threads(1)
CPU = torch.device("cpu")
WAVE = [("CRVAL3", "500.0"), ("CDELT3", "2.0"), ("CTYPE3", "'WAVE'")]


def make_cube(depth, hw, seed, special=True):
    rng = np.random.default_rng(seed)
    cube = (rng.random((depth, hw, hw)) * 50.0 + 0.5).astype(np.float32)
    if special and hw > 9:
        cube[:, 2, 3] = np.nan                 # a dead spaxel
        cube[-1, 5, 5] = np.inf
        cube[0, 6, 6] = -np.inf
        cube[:, 7, 1] = 0.0                    # all zero: median 0
        cube[:depth // 2, 8, 8] = 0.0
        cube[depth // 2, 9, 9] = np.nan
    return cube


def write_cube(tmp_path, cube, name="cube", bitpix=-32, cards=WAVE):
    p = str(tmp_path / f"{name}.fits")
    if bitpix == 16:
        data = np.nan_to_num(cube, nan=0.0, posinf=0.0, neginf=0.0)
        with open(p, "wb") as f:
            f.write(make_fits(np.round(data * 100.0 - 2000.0).astype(
                np.int16), bitpix=16, bscale=0.37, bzero=32768.0,
                naxis3=cube.shape[0], extra_cards=list(cards)))
    else:
        with open(p, "wb") as f:
            f.write(make_fits(cube, naxis3=cube.shape[0],
                              extra_cards=list(cards)))
    return p


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("depth,hw", [(8, 24), (40, 16)])
@pytest.mark.parametrize("bitpix", [-32, 16])
def test_extract_cube_equals_jax(tmp_path, depth, hw, bitpix):
    p = write_cube(tmp_path, make_cube(depth, hw, depth), bitpix=bitpix)
    got = extract_cube(p)
    want = jio.extract_cube(p)
    np.testing.assert_array_equal(bits(got.cube), bits(want.cube))
    assert got.header.cards == want.header.cards
    header, dev = load_cube(p, CPU)
    np.testing.assert_array_equal(bits(dev.numpy()), bits(want.cube))
    assert header.cards == want.header.cards


def test_extract_cube_skips_to_the_first_3d_hdu_and_refuses_2d(tmp_path):
    from astroburst_tpu_torch.errors import FitsError
    plane = make_fits(np.ones((4, 5), np.float32))
    cube = make_cube(6, 12, 1)
    p = str(tmp_path / "two.fits")
    with open(p, "wb") as f:
        f.write(plane + make_fits(cube, naxis3=6).replace(
            b"SIMPLE  =", b"XTENSION=", 1))
    np.testing.assert_array_equal(bits(extract_cube(p).cube),
                                  bits(jio.extract_cube(p).cube))
    flat = str(tmp_path / "flat.fits")
    with open(flat, "wb") as f:
        f.write(plane)
    with pytest.raises(FitsError, match="No 3D"):
        extract_cube(flat)
    with pytest.raises(FitsError, match="No 3D"):
        TLazy(flat)


@pytest.mark.parametrize("depth,hw", [(8, 24), (40, 16)])
@pytest.mark.parametrize("chunk", [None, 40 * 16 * 5])
def test_collapses_match_jax(monkeypatch, depth, hw, chunk):
    if chunk is not None:
        monkeypatch.setattr(te, "CHUNK_ELEMENTS", chunk)
    cube = make_cube(depth, hw, depth + 1)
    t = torch.from_numpy(cube)
    med = te.collapse_median(t).numpy()
    np.testing.assert_array_equal(bits(med),
                                  bits(je.collapse_median(jnp.asarray(cube))))
    mean = te.collapse_mean(t).numpy()
    want = np.asarray(je.collapse_mean(jnp.asarray(cube)))
    np.testing.assert_allclose(mean, want, rtol=1e-6, atol=0)
    assert med[7, 1] == 0.0 and np.isnan(want[2, 3]) == np.isnan(mean[2, 3])


def global_oracle(cube):
    """Exact order statistics of the finite non-zero values at the f32
    ranks of eager.rs:185-205 (np.partition), MAD of the deviations."""
    v = cube.reshape(-1)
    v = v[np.isfinite(v) & (v != 0.0)]
    n = np.float32(v.size)
    if v.size == 0:
        return 0.0, 1.0, 0.0, 1.0
    mid = int(np.floor(n / np.float32(2.0)))
    lo = int(np.floor(n * np.float32(0.01)))
    hi = int(min(np.floor(n * np.float32(0.999)), n - np.float32(1.0)))
    med = np.partition(v, mid)[mid]
    dev = np.abs(v - med)
    mad = np.partition(dev, mid)[mid]
    return (float(med), max(float(mad) * 1.4826, 1e-10),
            float(np.partition(v, lo)[lo]), float(np.partition(v, hi)[hi]))


@pytest.mark.parametrize("shape,seed", [((8, 24, 24), 1), ((40, 16, 16), 2),
                                        ((1, 33, 17), 3), ((3, 5, 5), 4)])
def test_global_stats_exact_and_near_jax(shape, seed):
    cube = make_cube(*shape[:2], seed)[:, :, :shape[2]]
    cube = np.ascontiguousarray(cube)
    got = te.compute_global_stats(torch.from_numpy(cube))
    want = je.compute_global_stats(jnp.asarray(cube))
    ora = global_oracle(cube)
    assert (got.median, got.sigma, got.low, got.high) == ora
    fin = cube[np.isfinite(cube) & (cube != 0)]
    tol = 2.0 * (fin.max() - fin.min()) / 8 ** 6
    assert abs(got.median - want.median) <= tol
    assert abs(got.low - want.low) <= tol
    assert abs(got.high - want.high) <= tol
    assert abs(got.sigma - want.sigma) <= 2 * tol * 1.4826


def test_global_stats_of_nothing_valid():
    cube = np.zeros((3, 4, 4), np.float32)
    cube[0, 0, 0] = np.nan
    g = te.compute_global_stats(torch.from_numpy(cube))
    assert (g.median, g.sigma, g.low, g.high) == (0.0, 1.0, 0.0, 1.0)
    assert je.compute_global_stats(jnp.asarray(cube)).__dict__ == g.__dict__


def test_normalize_and_u8_match_jax():
    cube = make_cube(8, 24, 5)
    g = te.compute_global_stats(torch.from_numpy(cube))
    jg = je.GlobalCubeStats(g.median, g.sigma, g.low, g.high)
    for z in (0, 1, 2, 3):
        got = te.normalize_with_global(torch.from_numpy(cube[z]), g).numpy()
        want = np.asarray(je.normalize_with_global(jnp.asarray(cube[z]), jg))
        assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(3.0))
        np.testing.assert_array_equal(got == 0, want == 0)
        u8 = tapi_cube._norm_u8(torch.from_numpy(cube[z]), g).numpy()
        ju8 = np.asarray(japi_cube._norm_u8(jnp.asarray(cube[z]), jg))
        assert np.abs(u8.astype(int) - ju8).max() <= 1
        mn, mx = want.min(), want.max()
        scaled = (want - mn) * np.float32(255.0 / max(mx - mn, 1e-10))
        far = np.abs(scaled - np.round(scaled)) > 1e-3
        np.testing.assert_array_equal(u8[far], ju8[far])


@pytest.mark.parametrize("cards,n", [
    (WAVE, 8), ([("CUNIT3", "'um'"), ("CDELT3", "0.002")], 50),
    ([], 3), ([], 100), ([], 8), ([("CRVAL3", "1.0"), ("CDELT3", "0.01")], 8),
    ([("CTYPE3", "'FREQ-LSR'"), ("CUNIT3", "'Hz'")], 4),
    ([("CUNIT3", "'KM/S'")], 6), ([("CRPIX3", "3.0"), ("CRVAL3", "1.5"),
                                   ("CDELT3", "-0.25"), ("NAXIS3", "6")], 6),
])
def test_classification_and_wavelengths_equal_jax(cards, n):
    got = te.classify_spectral_cube(HduHeader(list(cards)), n)
    want = je.classify_spectral_cube(JHeader(list(cards)), n)
    assert got.to_dict() == want.to_dict()
    h = list(cards) + [("NAXIS3", str(n))]
    assert te.build_wavelength_axis(HduHeader(h)) == \
        je.build_wavelength_axis(JHeader(h))


@pytest.mark.parametrize("depth,hw", [(8, 24), (40, 16)])
@pytest.mark.parametrize("bitpix", [-32, 16])
def test_lazy_cube_equals_jax(tmp_path, depth, hw, bitpix):
    cube = make_cube(depth, hw, depth + abs(bitpix))
    p = write_cube(tmp_path, cube, bitpix=bitpix)
    with TLazy(p, cache_frames=4) as tl, JLazy(p, cache_frames=4) as jl:
        assert tl.geometry.__dict__ == jl.geometry.__dict__
        for z in (0, depth - 1, 3, 0, 5, 6, 7, 2):
            np.testing.assert_array_equal(bits(tl.get_frame(z)),
                                          bits(jl.get_frame(z)))
        for y, x in ((0, 0), (hw // 2, hw // 2), (2, 3), (hw - 1, 1)):
            np.testing.assert_array_equal(bits(tl.spectrum(y, x)),
                                          bits(jl.spectrum(y, x)))
        np.testing.assert_array_equal(bits(tl.collapse_mean()),
                                      bits(jl.collapse_mean()))
        for mf in (256, 7):
            np.testing.assert_array_equal(
                bits(tl.collapse_median(mf, device=CPU).numpy()),
                bits(jl.collapse_median(mf)))
        starts = [(s, b.shape) for s, b in tl.iter_batches(3, 2)]
        assert starts == [(s, b.shape) for s, b in jl.iter_batches(3, 2)]
        assert tl.header.cards == jl.header.cards
        from astroburst_tpu_torch.errors import FitsError
        with pytest.raises(FitsError):
            tl.get_frame(depth)
        with pytest.raises(FitsError):
            tl.spectrum(hw, 0)


@pytest.mark.parametrize("case", ["normal", "ties", "extremes", "one",
                                  "chunks"])
def test_select_ranks_equal_np_partition(monkeypatch, case):
    """ops/select.py: rows sorted a chunk at a time (12 rows of 256 in
    the "chunks" case, the last padded), then the bisection over f32
    keys, give
    np.partition's values bit for bit (values and deviations about the median), NaN
    never counted, ranks past the count +inf, zeros as +0.0."""
    from astroburst_tpu_torch.ops import select as S
    rng = np.random.default_rng(11)
    x = {"normal": rng.normal(0, 3, 5000),
         "ties": rng.integers(-3, 4, 4000) * 0.5,
         "extremes": np.concatenate([rng.normal(0, 1e-38, 50),
                                     [np.inf, -np.inf, 3e38, -3e38, 1e-45],
                                     rng.normal(5, 1, 100)]),
         "one": np.array([2.5]),
         "chunks": rng.random(3000) - 0.25}[case].astype(np.float32)
    if case == "chunks":
        monkeypatch.setattr(S, "CHUNK", 256)
    xm = x.copy()
    xm[1::7] = np.nan
    v = xm[~np.isnan(xm)]
    ks = np.unique(np.array([0, v.size // 2, v.size // 3, v.size - 1]))
    def rows(around=None):
        def prep(seg):
            if around is not None:
                seg = torch.abs(seg - around)
            return torch.where(torch.isnan(seg), float("inf"), seg)
        return S.sorted_rows(torch.from_numpy(xm), prep)
    got = S.select_ranks(rows(), torch.from_numpy(ks)).numpy()
    want = np.array([np.partition(v, k)[k] for k in ks], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    med = want[np.searchsorted(ks, v.size // 2)]
    dev = np.abs(v - med)
    got = S.select_ranks(rows(torch.tensor(med)),
                         torch.from_numpy(ks)).numpy()
    want = np.array([np.partition(dev, k)[k] for k in ks], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    past = S.select_ranks(rows(), torch.tensor([v.size, v.size + 5])).numpy()
    assert np.isposinf(past).all()
