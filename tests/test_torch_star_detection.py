"""PyTorch port: star detection and its kernels' plain versions (K10 tile
sort, K11 window statistics) against the JAX package, K10's tile plan,
and the exact MAD selection against the sort form it replaced.

Inputs are made with numpy from a seed and fed to both packages; the
JAX Pallas kernels run in interpret mode, the rest on the XLA route, as
the JAX package's own tests run them. Tolerances:

- tile sort and valid counts: bit-equal;
- the MAD selection against the per-tile sort of deviations: bit-equal;
- background (median, sigma): abs 1e-5 / 1e-6, the JAX package's bound
  between its two background forms (test_star_detection.py:117-131);
- the packed detection: the valid set identical; cy, cx, flux, fwhm,
  peak, npix and snr within rel 1e-4, eccentricity within abs 0.01 —
  the JAX package's bound between its XLA and Pallas forms
  (test_star_detection.py:199-228): the moment sums are f32 in another
  order;
- ``detect_stars``: the same stars in the same order, positions and
  fluxes within rel 1e-4, npix equal.

The CUDA kernels run only on the card: chip_smoke.py holds them to these
plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.analysis import star_detection as jsd
from astroburst_tpu.analysis.tile_sort_kernel import sort_tiles_pallas
from astroburst_tpu.analysis.window_kernel import (pad_for_windows,
                                                   window_stats_pallas)
from astroburst_tpu_torch.analysis import star_detection as tsd
from astroburst_tpu_torch.analysis import tile_sort_kernel as tts
from astroburst_tpu_torch.analysis import window_kernel as twk

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _add_star(img, cy, cx, amp, sigma):
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]].astype(np.float64)
    img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def _field(shape=(256, 256), stars=((60.3, 80.7, 900.0, 1.8),
                                    (150.0, 40.0, 700.0, 2.2),
                                    (200.5, 200.5, 1200.0, 1.5)),
           bg=100.0, noise=2.0, seed=5):
    """tests/test_star_detection.py:make_field."""
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, noise, shape)
    for cy, cx, amp, sig in stars:
        _add_star(img, cy, cx, amp, sig)
    return img.astype(np.float32)


def _window_field():
    """512 × 640, 60 stars and a NaN patch crossing windows
    (tests/test_star_detection.py:208-216)."""
    rng = np.random.default_rng(5)
    h, w = 512, 640
    img = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(60):
        sy, sx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        a = rng.uniform(200, 2000)
        img += a * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 3.5)
    img[100:110, 200:210] = np.nan
    return img


def _assert_packed_close(got, ref):
    assert (got[8] == ref[8]).all()               # identical valid set
    v = ref[8] > 0.5
    for i in (0, 1, 2, 3, 5, 6, 7):   # cy cx flux fwhm peak npix snr
        rel = np.abs(got[i] - ref[i]) / np.maximum(np.abs(ref[i]), 1e-6)
        assert np.max(np.where(v, rel, 0)) < 1e-4, f"row {i}"
    assert np.max(np.where(v, np.abs(got[4] - ref[4]), 0)) < 0.01  # ecc
    np.testing.assert_allclose(got[9, :2], ref[9, :2], rtol=1e-6)


# ---- K10: the tile sort --------------------------------------------------


@pytest.mark.parametrize("shape,step", [((32, 64), 32), ((48, 64), 16)])
def test_sort_tiles_plain_matches_pallas_interpret(rng, shape, step):
    x = rng.normal(100, 10, shape).astype(np.float32)
    x[x < 88] = np.nan
    x[0, :3] = 0.0                 # at or below the padding threshold
    x[1, 5] = 1e-7
    x[2, 7] = np.inf
    x[3, 1] = -np.inf
    want = sort_tiles_pallas(jnp.asarray(x), step, interpret=True)
    got = tts.sort_tiles(_t(x), step)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("step", [125, 33])
def test_sort_tiles_plain_any_step_matches_numpy(rng, step):
    """Steps that are not powers of two, which the JAX code sent to
    XLA's sort (star_detection.py:191-203)."""
    x = rng.gamma(2.0, 50.0, (2 * step, 3 * step)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:, :2] = 0.0
    got, cnt = tts.sort_tiles(_t(x), step)
    tiles = x.reshape(2, step, 3, step).transpose(0, 2, 1, 3).reshape(
        6, step * step)
    valid = np.isfinite(tiles) & (tiles > 1e-7)
    np.testing.assert_array_equal(got.numpy(), np.sort(
        np.where(valid, tiles, np.inf), axis=1))
    np.testing.assert_array_equal(cnt.numpy(), valid.sum(1))


@pytest.mark.parametrize("step", [16, 32, 100, 125, 128, 129, 200, 256])
def test_sort_tiles_chunk_plan(step):
    """The kernel's chunk plan: powers of two that cover the tile, one
    chunk while it fits shared memory, else full-size chunks."""
    n = step * step
    chunk, n_chunks = tts._chunks(n)
    assert chunk & (chunk - 1) == 0 and n_chunks & (n_chunks - 1) == 0
    assert n <= chunk * n_chunks < 2 * max(n, 2)
    assert chunk <= tts.MAX_CHUNK
    if n_chunks > 1:
        assert chunk == tts.MAX_CHUNK


@pytest.mark.parametrize("step", [16, 32, 64, 90, 100, 125, 128, 129, 200,
                                  256, 257, 1000])
def test_sort_tiles_radix_plan(step):
    """The radix route's tile plan: the smallest cluster of 1, 2, 4 or 8
    blocks that holds the tile, the fewest threads (256 or 512) that
    hold a block's share, 16 keys a thread; one block up to 8192 keys
    (step <= 90), 8 at 256^2; past 8 full blocks the chunked route
    (None)."""
    n = step * step
    per_block = tts.MAX_THREADS * tts.KEYS_PER_THREAD
    plan = tts._tile_plan(n)
    if n > tts.MAX_CLUSTER * per_block:
        assert plan is None and step > 256
        return
    csize, threads = plan
    assert csize in (1, 2, 4, 8) and threads in (256, 512)
    assert csize * threads * tts.KEYS_PER_THREAD >= n
    if csize > 1:
        assert (csize // 2) * per_block < n and threads == tts.MAX_THREADS
    if threads > tts.MIN_THREADS:
        assert csize * (threads // 2) * tts.KEYS_PER_THREAD < n
    assert (csize == 1) == (step <= 90)
    if step == 256:
        assert plan == (8, 512)


def test_sort_tiles_rejects_bad_input():
    with pytest.raises(ValueError, match="device"):
        tts.sort_tiles(torch.zeros((64, 64), device="meta"), 32)
    with pytest.raises(ValueError, match="step"):
        tts.sort_tiles(torch.zeros((64, 60)), 32)


# ---- the exact MAD selection ------------------------------------------------


def _mad_by_sort(sorted_rows, lo, hi, med):
    """The MAD as the two middle ranks of the window's deviations
    |x − med| sorted per tile (the form ``_interval_mad`` replaced)."""
    cnt = hi - lo
    iota = torch.arange(sorted_rows.shape[1])
    window = (iota >= lo[:, None]) & (iota < hi[:, None])
    dev = torch.sort(torch.where(window, torch.abs(sorted_rows - med[:, None]),
                                 float("inf")), dim=1).values
    n = torch.clamp(cnt, min=1)
    v1 = tsd._at(dev, tsd._floordiv2(n - 1))
    v2 = tsd._at(dev, tsd._floordiv2(n))
    return torch.where(cnt > 0, (v1 + v2) * 0.5, 0.0)


def _mad_rows(case, rng):
    """(sorted rows with +inf tails, lo, hi) for one selection case."""
    t, p = 12, 700
    x = rng.gamma(2.0, 50.0, (t, p)).astype(np.float32)
    valid = rng.integers(p // 2, p + 1, t)
    lo = np.zeros(t, np.int64)
    hi = valid.copy()
    if case == "odd_and_even":
        hi = valid - (np.arange(t) % 2)
    elif case == "empty":
        lo = rng.integers(0, p // 2, t)
        hi = lo.copy()
    elif case in ("one", "two"):
        lo = rng.integers(0, p // 2, t)
        hi = lo + (1 if case == "one" else 2)
    elif case == "heavy_ties":
        x = (np.round(x / 25.0) * 25.0 + 1.0).astype(np.float32)
        x[:, : p // 3] = 100.0
    elif case == "inf_tails":
        valid = rng.integers(0, 40, t)
        hi = valid
    elif case == "lo_positive":
        lo = rng.integers(1, p // 3, t)
        hi = np.maximum(lo, valid - rng.integers(0, p // 4, t))
    elif case == "full_256_tile":
        t, p = 3, 65536
        x = rng.normal(100.0, 8.0, (t, p)).astype(np.float32)
        valid = np.array([p, p - 1000, p // 2])
        lo = np.array([0, 7, 300])
        hi = valid - np.array([0, 3, 4])
    for i in range(t):
        x[i, valid[i]:] = np.inf
    return (torch.from_numpy(np.sort(x, axis=1)), torch.from_numpy(lo),
            torch.from_numpy(hi))


@pytest.mark.parametrize("case", ["odd_and_even", "empty", "one", "two",
                                  "heavy_ties", "inf_tails", "lo_positive",
                                  "full_256_tile"])
def test_interval_mad_matches_sort_form(case):
    """The partition search over the two deviation runs gives the sort
    form's values, bit for bit: the same multiset's same ranks."""
    rows, lo, hi = _mad_rows(case, np.random.default_rng(17))
    med = tsd._interval_median(rows, lo, hi)
    got = tsd._interval_mad(rows, lo, hi, med)
    np.testing.assert_array_equal(got.numpy(),
                                  _mad_by_sort(rows, lo, hi, med).numpy())


def test_interval_mad_sorts_nothing(monkeypatch):
    rows, lo, hi = _mad_rows("lo_positive", np.random.default_rng(3))
    med = tsd._interval_median(rows, lo, hi)
    want = _mad_by_sort(rows, lo, hi, med)

    def no_sort(*a, **k):
        raise AssertionError("_interval_mad sorted")

    monkeypatch.setattr(torch, "sort", no_sort)
    np.testing.assert_array_equal(tsd._interval_mad(rows, lo, hi, med).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("p,rounds", [(1, 1), (256, 1), (257, 2),
                                      (15625, 2), (65536, 2), (65792, 2),
                                      (65793, 3)])
def test_probe_rounds_cover_the_tile(p, rounds):
    assert tsd._probe_rounds(p) == rounds


# ---- background ------------------------------------------------------------


@pytest.mark.parametrize("tile,use_pallas", [(32, False), (32, True),
                                             (48, False), (64, False)])
def test_background_matches_jax(rng, tile, use_pallas):
    img = rng.normal(50, 4, (70, 90)).astype(np.float32)
    img[10:12, 20:24] = np.nan
    img[40, 50] = 900.0
    img[60:62, 80:] = 0.0
    want = jsd._estimate_background_kernel(jnp.asarray(img), tile,
                                           use_pallas=use_pallas,
                                           interpret=True)
    got = tsd._background(_t(img), tile)
    assert float(got[0]) == pytest.approx(float(want[0]), abs=1e-5)
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-6)


def test_estimate_background_matches_jax():
    img = _field(stars=(), bg=500.0, noise=10.0)
    want = jsd.estimate_background(img, 64)
    got = tsd.estimate_background(img, 64, device=torch.device("cpu"))
    assert got[0] == pytest.approx(want[0], abs=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-6)
    assert got[0] == pytest.approx(500.0, abs=2.0)


def test_background_of_an_empty_plane():
    """No tile holds 8 valid pixels: (0, 1), as in JAX."""
    img = np.full((40, 40), np.nan, np.float32)
    want = jsd._estimate_background_kernel(jnp.asarray(img), 32,
                                           use_pallas=False)
    got = tsd._background(_t(img), 32)
    assert (float(got[0]), float(got[1])) == (float(want[0]),
                                              float(want[1])) == (0.0, 1.0)


# ---- K11: window statistics ------------------------------------------------


def test_window_stats_plain_matches_pallas_interpret():
    """The same peaks through both: the Pallas kernel on its padded
    plane, the plain version on the unpadded image."""
    img = _window_field()
    rng = np.random.default_rng(2)
    k, nv = 24, 20
    pys = rng.integers(0, img.shape[0], k).astype(np.int32)
    pxs = rng.integers(0, img.shape[1], k).astype(np.int32)
    pys[:4] = [0, 511, 105, 3]          # edges and the NaN patch
    pxs[:4] = [0, 639, 205, 637]
    thr, bg = np.float32(110.0), np.float32(100.0)
    wpad, top, left = pad_for_windows(jnp.asarray(img), 41)
    want = np.asarray(window_stats_pallas(
        wpad, jnp.asarray(pys + top), jnp.asarray(pxs + left), thr, bg, 41,
        interpret=True, n_valid=jnp.int32(nv)))
    got = twk.window_stats(_t(img), torch.from_numpy(pys),
                           torch.from_numpy(pxs), torch.tensor(thr),
                           torch.tensor(bg), torch.tensor(nv)).numpy()
    assert got.shape == (k, 9)
    np.testing.assert_array_equal(got[nv:], 0.0)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])       # npix
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_window_fill_stops_after_half_rounds():
    """A winding component is cut at the same depth as the XLA path's
    exactly-``half`` dilation rounds: a zig-zag ridge from the peak
    whose far end is more than 20 steps away."""
    img = np.full((64, 64), 100.0, np.float32)
    img[32, 20:44] = 200.0               # 24 px to the right of x = 20
    img[33:40, 43] = 200.0
    img[40, 10:44] = 200.0
    img[32, 20] = 300.0
    pys = np.int32([32])
    pxs = np.int32([20])
    got = twk.window_stats(_t(img), torch.from_numpy(pys),
                           torch.from_numpy(pxs), torch.tensor(150.0),
                           torch.tensor(100.0), torch.tensor(1)).numpy()
    # the window is x in [0, 40], y in [12, 52]: 21 px of the ridge are
    # within 20 rounds (x = 20..40)
    assert got[0, 0] == 21.0
    wpad, top, left = pad_for_windows(jnp.asarray(img), 41)
    want = np.asarray(window_stats_pallas(
        wpad, jnp.asarray(pys + top), jnp.asarray(pxs + left),
        np.float32(150.0), np.float32(100.0), 41, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_window_stats_rejects_other_devices():
    meta = torch.zeros((64, 64), device="meta")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        twk.window_stats(meta, idx, idx, meta[0, 0], meta[0, 0], idx[0])


# ---- K11's fill in registers, mirrored; adversarial windows ------------------

WINDOW_CASES = ("spiral", "centre_nan_below_at_inf", "ring_at_threshold",
                "all_above", "corners_and_edges", "past_the_border",
                "field_dead_tail", "no_live_peak")


@pytest.fixture(scope="module")
def window_sets():
    """chip_smoke.py's adversarial windows (200 x 260 planes)."""
    import chip_smoke
    sets = chip_smoke.window_cases(np.random.default_rng(43))
    assert tuple(sets) == WINDOW_CASES
    return sets


def _k11_fill_mirror(above):
    """csrc/window_stats.cu's fill on one [41, 41] above-threshold mask.
    Lane l of the warp holds the 64-bit masks of rows l and l + 32 (a
    and b; b is empty past row 40). A round shuffles a and b from lanes
    l - 1 and l + 1 (lane 0's row 31 is lane 31's a, lane 31's row 32 is
    lane 0's b), dilates by shifts and ORs, ANDs with the row's above
    mask, and the warp leaves when no lane changed, or after HALF
    rounds. Returns the [41, 41] members and the rounds run."""
    w, half = twk.WINDOW, twk.HALF
    one, zero = np.uint64(1), np.uint64(0)
    rows = (above.astype(np.uint64) << np.arange(w, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)
    above_a = rows[:32].copy()
    above_b = np.zeros(32, np.uint64)
    above_b[:w - 32] = rows[32:]
    mem_a = np.zeros(32, np.uint64)
    mem_b = np.zeros(32, np.uint64)
    mem_a[half] = one << np.uint64(half)
    lane = np.arange(32)
    up, dn = (lane + 31) % 32, (lane + 1) % 32

    def spread(x):
        return x | (x << one) | (x >> one)

    rounds = 0
    while rounds < half:
        ua, ub, da, db = mem_a[up], mem_b[up], mem_a[dn], mem_b[dn]
        na = spread(np.where(lane > 0, ua, zero) | mem_a
                    | np.where(lane < 31, da, db)) & above_a
        nb = spread(np.where(lane > 0, ub, ua) | mem_b
                    | np.where(lane < 31, db, zero)) & above_b
        changed = bool(((na != mem_a) | (nb != mem_b)).any())
        mem_a, mem_b = na, nb
        rounds += 1
        if not changed:
            break
    masks = np.concatenate([mem_a, mem_b[:w - 32]])
    member = ((masks[:, None] >> np.arange(w, dtype=np.uint64)) & one) == one
    return member, rounds


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_k11_fill_mirror_matches_plain_membership(window_sets, case):
    """The kernel's fill (row masks across lanes, shuffles, the exit at
    the fixed point) gives exactly the members of window_stats_plain's
    HALF rounds, and its popcounts the plain npix."""
    img, pys, pxs, thr, bg, nv = window_sets[case]
    win, member = twk.window_members_plain(
        _t(img), torch.from_numpy(pys), torch.from_numpy(pxs),
        torch.tensor(thr))
    stats = twk.window_stats_plain(
        _t(img), torch.from_numpy(pys), torch.from_numpy(pxs),
        torch.tensor(thr), torch.tensor(bg), torch.tensor(len(pys))).numpy()
    above = (torch.isfinite(win) & (win > float(thr))).numpy()
    rounds = []
    for i in range(len(pys)):
        got, r = _k11_fill_mirror(above[i])
        np.testing.assert_array_equal(got, member[i].numpy())
        assert stats[i, 0] == got.sum()
        rounds.append(r)
    assert max(rounds) <= twk.HALF
    if case == "spiral":     # the ridge winds on past 20 steps
        assert rounds == [twk.HALF]
    if case == "ring_at_threshold":   # 3 x 3 core: fixed point at round 2
        assert rounds == [2] and stats[0, 0] == 9


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_stats_matches_pallas_on_adversarial_windows(window_sets,
                                                            case):
    img, pys, pxs, thr, bg, nv = window_sets[case]
    wpad, top, left = pad_for_windows(jnp.asarray(img), 41)
    want = np.asarray(window_stats_pallas(
        wpad, jnp.asarray(pys + top), jnp.asarray(pxs + left), thr, bg, 41,
        interpret=True, n_valid=jnp.int32(nv)))
    before = twk.window_stats.launches
    got = twk.window_stats(_t(img), torch.from_numpy(pys),
                           torch.from_numpy(pxs), torch.tensor(thr),
                           torch.tensor(bg),
                           torch.tensor(nv, dtype=torch.int32)).numpy()
    assert twk.window_stats.launches == before   # the CPU path: no launch
    np.testing.assert_array_equal(got[nv:], 0.0)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])       # npix
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


# ---- peaks and the packed detection -----------------------------------------


def test_local_maxima_tie_rule_matches_jax(rng):
    img = rng.normal(0, 1, (30, 40)).astype(np.float32)
    img[10:13, 10:13] = 5.0              # a flat plateau: one peak
    img[20, 20] = img[20, 21] = 7.0      # a tied pair
    img[0, 5] = 9.0                      # the border is never a peak
    mask = img > 0.5
    want = np.asarray(jsd._local_maxima(jnp.asarray(img),
                                        jnp.asarray(mask)))
    got = tsd._local_maxima(_t(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[10:13, 10:13].sum() == 1 and got[20, 20:22].sum() == 1


@pytest.mark.parametrize("use_pallas", [False, True])
def test_packed_detection_matches_jax(use_pallas):
    img = _window_field()
    ref = np.asarray(jsd._detect_fused(jnp.asarray(img), 64, 5.0, 256,
                                       use_pallas=use_pallas,
                                       interpret=True))
    got = tsd._detect(_t(img), 64, 5.0, 256).numpy()
    assert got.shape == ref.shape == (10, 256)
    assert int(ref[8].sum()) >= 50
    _assert_packed_close(got, ref)


def _slab():
    """71 tight blobs peaking in one 2-row slab
    (tests/test_star_detection.py:149-167)."""
    rng = np.random.default_rng(1234)
    h, w = 64, 512
    img = rng.normal(100.0, 0.5, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for x in np.arange(5, 502, 7):
        img += 500.0 * np.exp(-((yy - 2.0) ** 2 + (xx - x) ** 2) / 1.0)
    return img


def _small():
    rng = np.random.default_rng(1234)
    img = rng.normal(100, 3, (40, 40)).astype(np.float32)
    yy, xx = np.mgrid[0:40, 0:40].astype(np.float32)
    for sy, sx in [(12, 12), (28, 30)]:
        img += 800.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 3.0)
    return img


def _elongated():
    rng = np.random.default_rng(1)
    img = rng.normal(100.0, 1.0, (128, 128))
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    img += 800.0 * np.exp(-((yy - 64) ** 2 / (2 * 1.5 ** 2) +
                            (xx - 64) ** 2 / (2 * 4.0 ** 2)))
    return img.astype(np.float32)


def _nan_field():
    img = _field()
    img[10:20, 10:20] = np.nan
    img[100, :] = np.inf
    return img


def _noise():
    return np.random.default_rng(0).normal(100.0, 3.0, (128, 128)).astype(
        np.float32)


FIELDS = {
    "three_stars": (_field, 5.0, 1024),
    "one_star_fwhm": (lambda: _field(stars=((128.0, 128.0, 1000.0, 2.0),),
                                     noise=0.5), 5.0, 1024),
    "nan_inf": (_nan_field, 5.0, 1024),
    "flat_noise": (_noise, 6.0, 1024),
    "elongated": (_elongated, 5.0, 1024),
    "40x40": (_small, 5.0, 1024),
    "71_peak_slab": (_slab, 5.0, 256),
    "window_field": (_window_field, 5.0, 256),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_detect_stars_matches_jax(name):
    make, sigma, max_peaks = FIELDS[name]
    img = make()
    want = jsd.detect_stars(img, sigma, max_peaks)
    got = tsd.detect_stars(img, sigma, max_peaks, device=torch.device("cpu"))
    assert (got.image_width, got.image_height) == (want.image_width,
                                                   want.image_height)
    assert got.background_median == pytest.approx(want.background_median,
                                                  abs=1e-5)
    assert got.background_sigma == pytest.approx(want.background_sigma,
                                                 abs=1e-6)
    assert len(got.stars) == len(want.stars)
    for g, w in zip(got.stars, want.stars):
        assert g.npix == w.npix
        for f in ("x", "y", "flux", "fwhm", "peak", "snr"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-4), f
        assert g.eccentricity == pytest.approx(w.eccentricity, abs=0.01)
    if name == "71_peak_slab":
        assert len(got.stars) >= 71


def test_detect_stars_tiny_and_pair():
    cpu = torch.device("cpu")
    res = tsd.detect_stars(np.ones((2, 2), np.float32), device=cpu)
    assert res.stars == [] and res.background_sigma == 1.0
    a, b = _field(), _field(seed=6)
    pa, pb = tsd.detect_stars_pair(a, b, 5.0, device=cpu)
    ja, jb = jsd.detect_stars_pair(a, b, 5.0)
    for got, want in ((pa, ja), (pb, jb)):
        assert [(round(s.x, 3), round(s.y, 3)) for s in got.stars] == \
            [(round(s.x, 3), round(s.y, 3)) for s in want.stars]
