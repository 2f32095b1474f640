"""PyTorch port: phase correlation and the plain version of kernel K1
(coarse box mean + frame stats) against the JAX package.

Tolerances:
- K1 plain against the Pallas kernel (interpret mode, bf16 inputs):
  rtol 5e-3; against the f32 XLA box mean: rtol 1e-5; stats exact;
- offsets: atol 0.05 px; confidences: rtol 1e-3 (sums over the
  correlation surface in another order, FFTs by another library).

A non-finite pixel poisons the whole JAX coarse surface (its band
matmuls multiply it by 0, and 0·NaN = NaN), while the port's direct
box sum poisons only that pixel's box. On frames with NaN pixels the
coarse surfaces therefore differ, and only the final offsets are
compared (shifts ≤ ±12 px).

The sub-pixel step is held to the parabola vertex (ROADMAP C8): JAX's
``_quadratic`` returns the vertex negated, so every comparison here
runs the JAX package with ``_quadratic`` replaced by the vertex formula
(``jax_parabola_vertex``, also imported by the other port test files
that compare offsets with JAX), and ``test_quadratic_is_the_vertex``
holds the port's to a numpy parabola.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.alignment import phase_correlation as jpc
from astroburst_tpu.alignment.coarse_kernel import (
    coarse_downsample_stack as jk1)
from astroburst_tpu_torch.alignment import phase_correlation as tpc
from astroburst_tpu_torch.alignment.coarse_kernel import (
    coarse_downsample_stack, coarse_downsample_stack_plain)
from astroburst_tpu_torch.convert import stack_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")


_JAX_QUADRATIC = jpc._quadratic


def _jax_vertex(prev, center, nxt):
    """JAX's _quadratic with the vertex's sign: (next − prev) over its
    denominator (ROADMAP C8)."""
    denom = 2.0 * (2.0 * center - prev - nxt)
    small = jnp.abs(denom) < 1e-15
    off = jnp.where(small, 0.0, (nxt - prev) / jnp.where(small, 1.0, denom))
    return jnp.clip(off, -0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def jax_parabola_vertex():
    """Run the JAX phase correlation with the vertex sign fixed for
    every test of the module (its jit caches are cleared on entry and
    exit, so no trace of either version leaks)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpc, "_quadratic", _jax_vertex)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _star_field(rng, h, w, n_stars=6, sigma2=8.0):
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sy, sx in zip(rng.uniform(20, h - 20, n_stars),
                      rng.uniform(20, w - 20, n_stars)):
        base += 900.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / sigma2)
    return base.astype(np.float32)


def _targets(base, shifts):
    return np.stack([np.roll(base, s, axis=(0, 1)) for s in shifts])


def _both(ref, tgts):
    got = tpc.phase_correlate_stack(torch.from_numpy(ref),
                                    stack_from_numpy(tgts, CPU))
    want = jpc.phase_correlate_stack_traced(jnp.asarray(ref),
                                            jnp.asarray(tgts))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


# ---- K1 ---------------------------------------------------------------------


def test_k1_plain_matches_pallas_kernel_interpret(rng):
    """Padded stack + true_shape into the Pallas kernel, the unpadded
    stack into the port (the grid over-reads past Hp, so the NaN-safe
    row mask is exercised)."""
    n, h, w, hp, wp = 3, 850, 1200, 856, 1280
    frames = rng.normal(100, 10, (n, h, w)).astype(np.float32)
    frames[2] = 42.0
    padded = np.zeros((n, hp, wp), np.float32)
    padded[:, :h, :w] = frames
    ds, by, bx, mn, mx, cnt = jk1(jnp.asarray(padded), (h, w), 512,
                                  interpret=True, with_stats=True)
    before = coarse_downsample_stack.launches
    got = coarse_downsample_stack(stack_from_numpy(frames, CPU), 512,
                                  with_stats=True)
    assert coarse_downsample_stack.launches == before
    assert got[1:3] == (by, bx) == (2, 3)
    assert got[0].shape == ds.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ds), rtol=5e-3)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(mn))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(mx))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(cnt))


@pytest.mark.parametrize("h,w", [(850, 1200), (400, 1200), (1200, 400),
                                 (5655 // 8, 2206 // 4)])
def test_k1_plain_matches_xla_box_mean(rng, h, w):
    frames = rng.normal(100, 10, (2, h, w)).astype(np.float32)
    want, by, bx = jpc._coarse_box_downsample(jnp.asarray(frames), 512)
    got, gby, gbx = coarse_downsample_stack_plain(torch.from_numpy(frames),
                                                  512)
    assert (gby, gbx) == (by, bx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_k1_stats_and_nan_box(rng):
    """Stats over every true pixel (remainder rows/cols included, NaN
    and inf excluded); a NaN pixel makes only its own box NaN."""
    frames = rng.normal(100, 10, (2, 1030, 1100)).astype(np.float32)
    frames[0, 5, 7] = np.nan
    frames[0, 1029, 1099] = -5.0          # remainder row and column
    frames[1, 100:110, 50:60] = np.inf
    ds, by, bx, mn, mx, cnt = coarse_downsample_stack_plain(
        torch.from_numpy(frames), 512, with_stats=True)
    fin = np.isfinite(frames)
    np.testing.assert_array_equal(cnt.numpy(), fin.sum(axis=(1, 2)))
    assert mn[0].item() == -5.0
    assert mx[1].item() == frames[1][fin[1]].max()
    bad = ~np.isfinite(ds[0].numpy())
    assert bad.sum() == 1 and bad[5 // by, 7 // bx]
    jds, _, _ = jpc._coarse_box_downsample(jnp.asarray(frames[0]), 512)
    assert np.isnan(np.asarray(jds)).all()   # the JAX surface is poisoned


# ---- helpers kept verbatim -------------------------------------------------------


def test_origin_arithmetic_matches_jax():
    for rows, cols in [(5655, 2206), (640, 1152), (513, 700), (300, 2000)]:
        assert tpc._crop_origin_static(rows, cols, 512) == \
            jpc._crop_origin_static(rows, cols, 512)
        cy = np.arange(-20, rows + 20, 7, dtype=np.int32)
        cx = np.resize(np.arange(-70, cols + 70, 3, dtype=np.int32),
                       cy.shape)
        ty, tx = tpc._refine_origin(torch.from_numpy(cy),
                                    torch.from_numpy(cx), rows, cols, 512)
        jy, jx = jpc._refine_origin(jnp.asarray(cy), jnp.asarray(cx), rows,
                                    cols, 512)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_peak_stats_tie_goes_to_lowest_index(rng):
    corr = rng.normal(0, 1, (2, 16, 32)).astype(np.float32)
    corr[0, 3, 5] = corr[0, 9, 1] = 50.0
    corr[1, 0, 31] = corr[1, 15, 0] = 50.0
    idx, peak, s, s2 = tpc._peak_stats(torch.from_numpy(corr))
    jidx, jpeak, js, js2 = jpc._peak_stats(jnp.asarray(corr))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [3 * 32 + 5, 31]
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5)


def test_quadratic_is_the_vertex():
    """Samples of y = a·(x − v)² + c at x = −1, 0, 1 give back v."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-0.5, 0.5, 200)
    a = -rng.uniform(0.1, 5.0, 200)
    c = rng.uniform(1.0, 10.0, 200)
    p, m, q = (torch.from_numpy(a * (x - v) ** 2 + c) for x in (-1, 0, 1))
    np.testing.assert_allclose(tpc._quadratic(p, m, q).numpy(), v,
                               atol=1e-9)
    pmq = [jnp.asarray(x.numpy(), jnp.float32) for x in (p, m, q)]
    np.testing.assert_allclose(np.asarray(_jax_vertex(*pmq)), v, atol=1e-5)
    # the JAX package's own step returns the vertex negated
    np.testing.assert_allclose(np.asarray(_JAX_QUADRATIC(*pmq)), -v,
                               atol=1e-5)


def test_subpixel_shifts_are_recovered(rng):
    """Frames moved by sub-pixel amounts (a smooth star field, rendered
    analytically) come back within 0.15 px."""
    h, w = 256, 288
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    stars = list(zip(rng.uniform(12, h - 12, 40), rng.uniform(12, w - 12, 40),
                     rng.uniform(300, 3000, 40)))
    shifts = [(0.3, -0.7), (1.45, 0.25), (-1.2, 1.9), (0.5, 0.5)]

    def render(dy, dx):
        f = np.full((h, w), 200.0)
        for sy, sx, amp in stars:
            f += amp * np.exp(-((yy - sy - dy) ** 2 + (xx - sx - dx) ** 2)
                              / (2 * 1.6 ** 2))
        return (f + rng.normal(0, 3.0, (h, w))).astype(np.float32)

    ref = render(0.0, 0.0)
    tgts = np.stack([render(dy, dx) for dy, dx in shifts])
    dy, dx, _ = tpc.phase_correlate_stack(torch.from_numpy(ref),
                                          stack_from_numpy(tgts, CPU))
    np.testing.assert_allclose(np.stack([dy.numpy(), dx.numpy()], 1),
                               shifts, atol=0.15)


@pytest.mark.parametrize("shape", [(64, 96), (1, 64), (33, 1)])
def test_correlate_single_matches_jax(rng, shape):
    a = rng.normal(0, 1, shape).astype(np.float32)
    b = np.roll(a, (min(3, shape[0] - 1), min(-2, shape[1] - 1)), (0, 1))
    b = np.stack([b, a])
    got = tpc.correlate_single(torch.from_numpy(a), torch.from_numpy(b))
    want = jpc.correlate_single(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0.05)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=1e-3)


# ---- phase_correlate_stack ----------------------------------------------------------


def test_stack_matches_traced_coarse_to_fine(rng):
    h, w = 640, 1152
    base = _star_field(rng, h, w)
    shifts = [(3, -5), (-7, 11), (0, 0)]
    got, want = _both(base, _targets(base, shifts))
    np.testing.assert_allclose(got[0], want[0], atol=0.05)
    np.testing.assert_allclose(got[1], want[1], atol=0.05)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3)
    np.testing.assert_allclose(got[0], [s[0] for s in shifts], atol=0.05)
    np.testing.assert_allclose(got[1], [s[1] for s in shifts], atol=0.05)


def test_stack_matches_traced_single_scale(rng):
    base = _star_field(rng, 300, 400)
    got, want = _both(base, _targets(base, [(4, -9), (-2, 1)]))
    for g, wv in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, wv, atol=0.05)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3)


def test_phase_correlate_host_api_matches_jax(rng):
    """The pair API crops both planes to their common dims and returns
    host floats; the confidence gate of drizzle reads them."""
    base = _star_field(rng, 640, 1152)
    tgt = np.roll(base, (-6, 9), (0, 1))[:630, :1140]
    got = tpc.phase_correlate(torch.from_numpy(base), torch.from_numpy(tgt))
    want = jpc.phase_correlate(base, tgt)
    assert isinstance(got, tpc.PhaseCorrelationResult)
    assert got.dy == pytest.approx(want.dy, abs=0.05)
    assert got.dx == pytest.approx(want.dx, abs=0.05)
    assert got.confidence == pytest.approx(want.confidence, rel=1e-3)
    assert got.dy == pytest.approx(-6.0, abs=0.1)
    assert got.dx == pytest.approx(9.0, abs=0.1)
    assert not tpc.is_low_confidence(got.confidence)
    assert tpc.is_low_confidence(1.99) and not tpc.is_low_confidence(2.0)


def test_stack_constant_frame_gate(rng):
    h, w = 640, 1152
    base = _star_field(rng, h, w)
    tgts = np.stack([np.roll(base, (3, -5), (0, 1)),
                     np.full((h, w), 7.0, np.float32)])
    got, want = _both(base, tgts)
    assert got[0][0] == pytest.approx(3.0, abs=0.05)
    assert got[1][0] == pytest.approx(-5.0, abs=0.05)
    assert got[0][1] == got[1][1] == got[2][1] == 0.0
    np.testing.assert_array_equal(got[0][1:], want[0][1:])


def test_stack_with_nan_pixels_offsets_agree(rng):
    """Frames with NaN pixels: JAX's coarse surface is all NaN (coarse
    shift 0), the port's is not; both refine to the same offsets."""
    h, w = 640, 1152
    base = _star_field(rng, h, w, n_stars=8)
    shifts = [(12, -12), (-9, 7), (5, 11)]
    tgts = _targets(base, shifts)
    for k in range(3):
        m = rng.random((h, w)) < 1e-4
        tgts[k][m] = np.nan
    ref = base.copy()
    ref[17, 33] = np.nan
    got, want = _both(ref, tgts)
    np.testing.assert_allclose(got[0], want[0], atol=0.05)
    np.testing.assert_allclose(got[1], want[1], atol=0.05)
    np.testing.assert_allclose(got[0], [s[0] for s in shifts], atol=0.05)
    np.testing.assert_allclose(got[1], [s[1] for s in shifts], atol=0.05)
