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


def select_case(case):
    """The values of one ``test_select_ranks_equal_np_partition`` case:
    the first five are plain samples; the rest are the radix select's
    edges (csrc/radix_select.cu): every value equal; nothing finite and
    non-zero; one valid value among NaN and zeros; negative values
    only; ±0 beside values; subnormals; many ±inf and NaN; over 99% in
    one top-11-bit key bin ([1, 1.25)); a count at which the 1% rank is
    0 and the 99.9% rank cnt − 1; and a count that is no multiple of
    the 16-byte vector width."""
    rng = np.random.default_rng(11)
    x = {"normal": rng.normal(0, 3, 5000),
         "ties": rng.integers(-3, 4, 4000) * 0.5,
         "extremes": np.concatenate([rng.normal(0, 1e-38, 50),
                                     [np.inf, -np.inf, 3e38, -3e38, 1e-45],
                                     rng.normal(5, 1, 100)]),
         "one": np.array([2.5]),
         "chunks": rng.random(3000) - 0.25}.get(case)
    if x is not None:
        return x.astype(np.float32)
    if case == "signed_zeros":
        x = rng.normal(0, 1, 2000)
        x[rng.random(2000) < 0.3] = 0.0
        x[rng.random(2000) < 0.3] = -0.0
    elif case == "inf_nan":
        x = rng.normal(5, 2, 3000)
        r = rng.random(3000)
        x[r < 0.1] = np.inf
        x[(r >= 0.1) & (r < 0.2)] = -np.inf
        x[(r >= 0.2) & (r < 0.3)] = np.nan
    elif case == "one_valid":
        x = np.full(1000, np.nan)
        x[::3] = 0.0
        x[500] = 7.25
    else:
        x = {"all_equal": lambda: np.full(3001, 3.5),
             "none_valid": lambda: rng.permutation(np.repeat(
                 [np.nan, 0.0, -0.0, np.inf, -np.inf], 500)),
             "negative": lambda: -rng.gamma(2.0, 3.0, 3000) - 0.1,
             "subnormals": lambda: np.concatenate([
                 rng.normal(0, 1e-39, 3000), rng.normal(0, 1e-44, 200),
                 [1.5, -2.5]]),
             "one_bin": lambda: np.concatenate([
                 1.0 + 0.25 * rng.random(4000), rng.normal(0, 100, 20)]),
             "rank_ends": lambda: rng.normal(2, 1, 66),
             "odd_n": lambda: rng.lognormal(0, 2, 4999)}[case]()
    return x.astype(np.float32)


SELECT_CASES = ["normal", "ties", "extremes", "one", "chunks", "all_equal",
                "none_valid", "one_valid", "negative", "signed_zeros",
                "subnormals", "inf_nan", "one_bin", "rank_ends", "odd_n"]


@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_ranks_equal_np_partition(monkeypatch, case):
    """ops/select.py: rows sorted a chunk at a time (12 rows of 256 in
    the "chunks" case, the last padded), then the bisection over f32
    keys, give
    np.partition's values bit for bit (values and deviations about the median), NaN
    never counted, ranks past the count +inf, zeros as +0.0; and
    ``compute_global_stats`` (its plain route, as the CPU runs it) the
    oracle's statistics of the finite non-zero values."""
    from astroburst_tpu_torch.ops import select as S
    x = select_case(case)
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
    def nth(a, k):
        w = np.partition(a, k)[k]
        return np.float32(0.0) if w == 0 else w      # ±0 as +0.0
    got = S.select_ranks(rows(), torch.from_numpy(ks)).numpy()
    want = np.array([nth(v, k) for k in ks], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    med = want[np.searchsorted(ks, v.size // 2)]
    dev = np.abs(v - med)
    got = S.select_ranks(rows(torch.tensor(med)),
                         torch.from_numpy(ks)).numpy()
    want = np.array([nth(dev, k) for k in ks], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    past = S.select_ranks(rows(), torch.tensor([v.size, v.size + 5])).numpy()
    assert np.isposinf(past).all()
    g = te.compute_global_stats(torch.from_numpy(xm))
    assert (g.median, g.sigma, g.low, g.high) == global_oracle(xm)
    if case == "rank_ends":
        n = np.float32(np.count_nonzero(np.isfinite(xm) & (xm != 0)))
        assert np.floor(n * np.float32(0.01)) == 0
        assert np.floor(n * np.float32(0.999)) >= n - 1


def radix_keys(a):
    """csrc/radix_select.cu's key_of: f32 bits, the sign bit set for a
    positive value, every bit flipped for a negative one."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def radix_value(u):
    """value_of: the f32 of a key, +0.0 for either zero."""
    u = np.uint32(u)
    b = u ^ np.uint32(0x80000000) if u & 0x80000000 else ~u
    f = np.array([b], np.uint32).view(np.float32)[0]
    return np.float32(0.0) if f == 0 else f


def radix_select_model(keys, k):
    """The kernel's passes and choose steps for one rank k, in numpy:
    the 11-bit top digits' histogram, then 11 and 10 bits over the keys
    whose higher digits match the prefix chosen so far; a choose step
    takes the first bin whose running count passes k and keeps the rank
    left inside it. +inf when k is at or past the count."""
    pre, krem = None, int(k)
    for hi, shift, nbits in ((None, 21, 11), (21, 10, 11), (10, 0, 10)):
        sel = keys if pre is None else keys[(keys >> hi) == pre]
        hist = np.bincount((sel >> shift) & ((1 << nbits) - 1),
                           minlength=1 << nbits)
        cum = np.cumsum(hist)
        if krem >= cum[-1]:
            return np.float32(np.inf)
        b = int(np.searchsorted(cum, krem, side="right"))
        krem -= int(cum[b] - hist[b])
        pre = b if pre is None else (pre << nbits) | b
    return radix_value(pre)


@pytest.mark.parametrize("case", SELECT_CASES)
def test_radix_select_model_equals_np_partition(case):
    """The radix select's digit and rank plan (csrc/radix_select.cu,
    mirrored in numpy: keys, prefixes, histograms, the choose steps) at
    the ranks of ``rank_indices`` and at 0, cnt − 1 and past the count:
    the values and the MAD bit-equal to np.partition's, zeros as
    +0.0, +inf past the count. The keys order as the floats do."""
    from astroburst_tpu_torch.ops.select import RANK_FRACS, rank_indices
    x = select_case(case)
    valid = x[np.isfinite(x) & (x != 0)]
    n = valid.size
    ks = rank_indices(torch.tensor(n), RANK_FRACS).tolist()
    keys = radix_keys(valid)
    assert np.all(np.diff(keys[np.argsort(valid, kind="stable")].astype(
        np.int64)) >= 0)
    def nth(a, k):
        w = np.partition(a, k)[k] if k < a.size else np.float32(np.inf)
        return np.float32(0.0) if w == 0 else w
    for k in ks + [0, max(n - 1, 0), n, n + 3]:
        assert bits(radix_select_model(keys, k)) == bits(nth(valid, k)), k
    med = radix_select_model(keys, ks[0])
    dev = np.abs(valid - med).astype(np.float32)
    assert bits(radix_select_model(radix_keys(dev), ks[0])) == \
        bits(nth(dev, ks[0]))


def test_radix_workspace_matches_the_kernel_layout():
    """ops/select.WORKSPACE_WORDS is the u64 words the kernel's layout
    asserts: 16 of counts and rank slots, then six histograms."""
    import re
    from astroburst_tpu_torch.ops import select as S
    from astroburst_tpu_torch.runtime import kernels as K
    src = (K.CSRC / "radix_select.cu").read_text()
    m = re.search(r"static_assert\(kHistM2 \+ 1024 == (\d+) \+ (\d+)", src)
    assert int(m.group(1)) + int(m.group(2)) == S.WORKSPACE_WORDS
    assert S.WORKSPACE_WORDS == 16 + 2048 + 3 * 2048 + 3 * 1024 + 2048 + \
        2048 + 1024


def test_global_stats_plain_route_counts_nothing_on_the_cpu():
    """On the CPU ``compute_global_stats`` runs the plain version and
    counts neither ``cube.stats.plain`` (kept for a CUDA cube inside
    ``plain_versions()``) nor ``cube.stats.radix_select``; both names
    sit in runtime/trace.py's table."""
    from astroburst_tpu_torch.ops import select as S
    from astroburst_tpu_torch.runtime import trace
    trace.enable()
    try:
        trace.drain()
        launches = S.global_stats.launches
        g = te.compute_global_stats(torch.from_numpy(make_cube(8, 24, 3)))
        got = trace.drain()
    finally:
        trace.disable()
    assert (g.median, g.sigma, g.low, g.high) == global_oracle(
        make_cube(8, 24, 3))
    assert "cube.stats.plain" not in got.counters
    assert "cube.stats.radix_select" not in got.counters
    assert S.global_stats.launches == launches
    for name in ("cube.stats.plain", "cube.stats.radix_select"):
        assert f"``{name}``" in trace.__doc__


def test_process_cube_cmd_calls_compute_global_stats_as_api_cube_binds_it(
        tmp_path, monkeypatch):
    """The benchmark's outside wrapper replaces
    ``astroburst_tpu_torch.api.cube:compute_global_stats``; the eager
    command calls that name, once, on the whole cube."""
    calls = []
    real = tapi_cube.compute_global_stats

    def recorded(cube):
        calls.append(tuple(cube.shape))
        return real(cube)
    monkeypatch.setattr(tapi_cube, "compute_global_stats", recorded)
    cube = make_cube(8, 24, 4)
    p = write_cube(tmp_path, cube)
    try:
        tapi_cube.process_cube_cmd(p, str(tmp_path / "out"), device=CPU)
    finally:
        for c in tapi_cube._LAZY_CUBES.values():
            c.close()
        tapi_cube._LAZY_CUBES.clear()
    assert calls == [cube.shape]
