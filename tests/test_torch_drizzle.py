"""PyTorch port: exact drizzle, its finalize kernels' plain versions
(K7, K8) and ``drizzle_stack`` against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The
JAX Pallas finalize kernels run in interpret mode, the drizzle code
on its XLA route, as the JAX package's own tests run them. Tolerances
are the JAX package's own (tests/test_reference_impl.py:170-262):

- image atol 2e-4 / rtol 1e-6; weight map atol 1e-5; rejected count
  equal for the square kernel;
- gaussian/lanczos3: rejected count within max(5, 5 %) — f32 exp/sin
  of two libraries flip presence at the 1e-12 threshold
  (test_reference_impl.py:180-184);
- offsets within 1e-3 px of JAX's, whose phase correlation runs with
  its sub-pixel step held to the parabola vertex
  (``jax_parabola_vertex``, ROADMAP C8);
- against the scatter oracle tests/reference_impl ``ref_drizzle``: the
  tolerances of ``test_drizzle_exact_matches_scatter_oracle``.

The parity drizzle (``drizzle_exact_parity``, K9's plain version)
against JAX's, whose Pallas kernel runs in interpret mode, at the
tolerances of tests/test_reference_impl.py:295-299 (image atol 2e-4 /
rtol 1e-6, weights atol 1e-5, rejected count equal), and bit-equal to
the port's own one-band ``_drizzle_kernel_exact``.

The exact drizzle's one route (``_drizzle_one_launch``: one batched
tap pass, then ``drizzle_gather_banded``) with the gather's plain
version: its per-row tap tables bit-equal to each band's own taps, its
result against the JAX package's band loop in every depth instance.

The CUDA kernels themselves run only on the card: chip_smoke.py holds
them to these plain versions there.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import dtypes as jdt
from astroburst_tpu.stacking import drizzle as jdz
from astroburst_tpu.stacking.drizzle_kernel import (
    drizzle_finalize_fused as jk7, drizzle_finalize_pallas as jk8)
from astroburst_tpu_torch import dtypes as tdt
from astroburst_tpu_torch.convert import stack_from_numpy
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking import drizzle as tdz
from astroburst_tpu_torch.stacking import drizzle_gather_kernel as tdg
from astroburst_tpu_torch.stacking import drizzle_kernel as tdk
from tests.reference_impl import ref_drizzle
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
KERNELS = ["square", "gaussian", "lanczos3"]


def _frames(rng, n, h, w, outlier=True, nans=True):
    frames = [rng.normal(10, 1, (h, w)).astype(np.float32) for _ in range(n)]
    if outlier:
        frames[1][h // 2, w // 2] = 300.0
    if nans:
        frames[0][3, 4] = np.nan
        frames[2 % n][h - 4, w - 5] = np.nan
        frames[-1][1, w - 2] = np.inf
    return frames


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _rej_ok(kern, got, want):
    if kern == "square":
        return int(got) == int(want)
    return abs(int(got) - int(want)) <= max(5, int(0.05 * int(want)))


# ---- K7 / K8 plain versions against the Pallas kernels --------------------


def _band(rng):
    """Raw candidates of 4 frames of 8 x 64 at scale 2, pixfrac 1 (two
    taps per axis): [4·2·2, 16, 128], with NaN/inf pixels and one
    outlier, built by both packages."""
    frames = _frames(rng, 4, 8, 64)
    frames[2][2:4, 10:14] = np.nan
    d_ys = np.float32([0.0, -0.35, 0.6, 0.15])
    d_xs = np.float32([0.0, 0.2, -0.45, -0.7])
    kern = jdt.DrizzleKernel.SQUARE
    parts = [jdz._frame_candidates_raw(jnp.asarray(f), jnp.float32(dy),
                                       jnp.float32(dx), 2.0, 1.0, kern, 16,
                                       128)
             for f, dy, dx in zip(frames, d_ys, d_xs)]
    j_cand = np.concatenate([np.asarray(p[0]) for p in parts])
    j_wys = np.concatenate([np.asarray(p[1]) for p in parts])
    j_wxs = np.concatenate([np.asarray(p[2]) for p in parts])
    t_cand, t_wys, t_wxs, taps = tdz._frame_candidates_raw(
        stack_from_numpy(np.stack(frames), CPU), torch.from_numpy(d_ys),
        torch.from_numpy(d_xs), 2.0, 1.0, tdt.DrizzleKernel.SQUARE, 16, 128)
    assert taps == parts[0][3] == 2
    np.testing.assert_array_equal(t_cand.numpy(), j_cand)
    np.testing.assert_array_equal(t_wys.numpy(), j_wys)
    np.testing.assert_array_equal(t_wxs.numpy(), j_wxs)
    return j_cand, j_wys, j_wxs


@pytest.mark.parametrize("iters", [0, 3, 5])
def test_k7_plain_matches_pallas_interpret(rng, iters):
    cand, wys, wxs = _band(rng)
    cap = 8
    want = jk7(jnp.asarray(cand), jnp.asarray(wys.T), jnp.asarray(wxs), 4, 2,
               2, cap, 3.0, 3.0, iters, interpret=True, block_w=128)
    got = tdk.drizzle_finalize_fused(
        torch.from_numpy(cand), torch.from_numpy(np.ascontiguousarray(wys.T)),
        torch.from_numpy(wxs), 4, 2, 2, cap, 3.0, 3.0, iters)
    _close(got[0], want[0], 2e-4, 1e-6, "image")
    _close(got[1], want[1], 1e-5, 0.0, "weight map")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) > 0 if iters else int(got[2].sum()) == 0


def test_k8_plain_matches_pallas_interpret(rng):
    cand, wys, wxs = _band(rng)
    w = (wys.reshape(4, 2, 1, 16, 1) * wxs.reshape(4, 1, 2, 1, 128)
         ).reshape(16, 16, 128)
    finite = np.isfinite(cand)
    v = np.where(finite, cand, 0.0).astype(np.float32)
    w = np.where(finite, w, 0.0).astype(np.float32)
    want = jk8(jnp.asarray(v), jnp.asarray(w), 8, 2.5, 3.0, 5,
               interpret=True, block_w=128)
    got = tdk.drizzle_finalize(torch.from_numpy(v), torch.from_numpy(w), 8,
                               2.5, 3.0, 5)
    _close(got[0], want[0], 2e-4, 1e-6, "image")
    _close(got[1], want[1], 1e-5, 0.0, "weight map")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # K7's plain version on the raw values gives the same planes
    k7 = tdk.drizzle_finalize_fused(
        torch.from_numpy(cand), torch.from_numpy(np.ascontiguousarray(wys.T)),
        torch.from_numpy(wxs), 4, 2, 2, 8, 2.5, 3.0, 5)
    for a, b in zip(got, k7):
        assert torch.equal(a, b)


def test_finalize_depth_limit_is_named():
    """Past MAX_CAP live values (more than 128 frames) the kernel takes
    its global-scratch instance: only an invalid cap or iteration count
    is refused."""
    tdk._check_common(256, 5)        # 128 frames: the deepest shared column
    tdk._check_common(258, 5)        # 129 frames: the global scratch
    with pytest.raises(ValueError, match="cap"):
        tdk._check_common(0, 5)
    with pytest.raises(ValueError, match="iterations"):
        tdk._check_common(4, -1)


def test_exact_drizzle_above_128_frames_matches_jax(rng):
    """130 frames (cap 260 > MAX_CAP): the plain finalize has no depth
    limit, and neither has the kernel now (chip_smoke.py holds its
    global-scratch instance to this plain version on the card)."""
    n = 130
    stack = np.stack(_frames(rng, n, 6, 8))
    d_ys = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    d_xs = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    d_ys[0] = d_xs[0] = 0.0
    ri, rw, rr = jdz._drizzle_kernel_exact(
        jnp.asarray(stack), jnp.asarray(d_ys), jnp.asarray(d_xs), 2.0, 1.0,
        jdt.DrizzleKernel.SQUARE, 12, 16, 3.0, 3.0, 3, band_rows=12,
        use_pallas=False)
    gi, gw, gr = tdz._drizzle_kernel_exact(
        stack_from_numpy(stack, CPU), torch.from_numpy(d_ys),
        torch.from_numpy(d_xs), 2.0, 1.0, tdt.DrizzleKernel.SQUARE, 12, 16,
        3.0, 3.0, 3, band_rows=12)
    _close(gi, ri, 2e-4, 1e-6, "image")
    _close(gw, rw, 1e-5, 1e-6, "weight map")   # sums of 520 weights
    assert int(gr) == int(rr) > 0


# ---- the exact and pre-averaging drizzle against JAX's XLA route ---------


def _drizzle_args(rng, n=4, h=14, w=20):
    frames = _frames(rng, n, h, w)
    offs = [(0.0, 0.0), (0.4, -0.25), (-0.3, 0.6), (1.2, 0.8)][:n]
    d_xs = np.float32([-o[0] for o in offs])
    d_ys = np.float32([-o[1] for o in offs])
    return np.stack(frames), d_ys, d_xs


@pytest.mark.parametrize("kern", KERNELS)
def test_drizzle_kernel_exact_matches_jax(rng, kern):
    stack, d_ys, d_xs = _drizzle_args(rng)
    jk = jdt.DrizzleKernel(kern)
    ri, rw, rr = jdz._drizzle_kernel_exact(
        jnp.asarray(stack), jnp.asarray(d_ys), jnp.asarray(d_xs), 2.0, 1.0,
        jk, 28, 40, 3.0, 3.0, 3, band_rows=8, use_pallas=False)
    ts = stack_from_numpy(stack, CPU)
    for plain in (False, True):
        with K.plain_versions() if plain else contextlib.nullcontext():
            gi, gw, gr = tdz._drizzle_kernel_exact(
                ts, torch.from_numpy(d_ys), torch.from_numpy(d_xs), 2.0,
                1.0, tdt.DrizzleKernel(kern), 28, 40, 3.0, 3.0, 3,
                band_rows=8)
        assert gi.shape == (28, 40) and gw.shape == (28, 40)
        _close(gi, ri, 2e-4, 1e-6, f"{kern} image plain={plain}")
        _close(gw, rw, 1e-5, 0.0, f"{kern} weights plain={plain}")
        assert _rej_ok(kern, gr, rr), (kern, int(gr), int(rr))


@pytest.mark.parametrize("kern", KERNELS)
def test_drizzle_preaverage_matches_jax(rng, kern):
    stack, d_ys, d_xs = _drizzle_args(rng)
    jk = jdt.DrizzleKernel(kern)
    ri, rw, rr = jdz._drizzle_kernel(
        jnp.asarray(stack), jnp.asarray(d_ys), jnp.asarray(d_xs), 1.5, 0.8,
        jk, 21, 30, 2.5, 3.0, 4)
    gi, gw, gr = tdz._drizzle_kernel(
        stack_from_numpy(stack, CPU), torch.from_numpy(d_ys),
        torch.from_numpy(d_xs), 1.5, 0.8, tdt.DrizzleKernel(kern), 21, 30,
        2.5, 3.0, 4)
    _close(gi, ri, 2e-4, 1e-6, f"{kern} image")
    _close(gw, rw, 1e-5, 1e-6, f"{kern} weights")
    assert _rej_ok(kern, gr, rr), (kern, int(gr), int(rr))


def test_band_rows_move_the_result_only_by_rounding(rng):
    """A band offsets d_y by − r0/scale, so the tap arithmetic of one
    output row rounds differently with another band height: the planes
    agree to f32 rounding, not bit for bit (ROADMAP C)."""
    stack, d_ys, d_xs = _drizzle_args(rng)
    ts = stack_from_numpy(stack, CPU)
    args = (ts, torch.from_numpy(d_ys), torch.from_numpy(d_xs), 2.0, 0.7,
            tdt.DrizzleKernel.SQUARE, 28, 40, 3.0, 3.0, 5)
    a = tdz._drizzle_kernel_exact(*args, band_rows=8)
    b = tdz._drizzle_kernel_exact(*args, band_rows=28)
    _close(a[0], b[0], 2e-4, 1e-6, "image")
    _close(a[1], b[1], 1e-5, 0.0, "weights")
    assert int(a[2]) == int(b[2])


@pytest.mark.parametrize("kern", KERNELS)
def test_drizzle_exact_matches_scatter_oracle(rng, kern):
    """The scatter oracle (tests/reference_impl/drizzle.py) on the
    adversarial config scale=2, pixfrac=1, with its cosmic ray."""
    frames = [rng.normal(10, 1, (16, 18)).astype(np.float32)
              for _ in range(4)]
    frames[1][8, 9] = 500.0
    offs = [(0.0, 0.0), (0.35, -0.2), (-0.6, 0.45), (0.15, 0.7)]
    ref_img, ref_wgt, ref_rej = ref_drizzle(frames, offs, 2.0, 1.0, kern,
                                            3.0, 3.0, 3)
    d_xs = torch.tensor([o[0] for o in offs], dtype=torch.float32)
    d_ys = torch.tensor([o[1] for o in offs], dtype=torch.float32)
    img, wgt, rej = tdz._drizzle_kernel_exact(
        stack_from_numpy(np.stack(frames), CPU), d_ys, d_xs, 2.0, 1.0,
        tdt.DrizzleKernel(kern), 32, 36, 3.0, 3.0, 3)
    _close(img, ref_img, 2e-4, 2e-5, "image")
    _close(wgt, ref_wgt, 1e-5, 1e-4, "weights")
    assert abs(int(rej) - ref_rej) <= max(5, int(0.05 * ref_rej))


# ---- drizzle_stack --------------------------------------------------------


def _star_frames(rng, n=5, h=64, w=72):
    """Dithered star fields: frame k is the scene moved by (dy_k, dx_k)
    (sub-pixel, |d| < 2), rendered analytically, plus noise."""
    dith = rng.uniform(-2, 2, (n, 2))
    dith[0] = 0.0
    ys = rng.uniform(6, h - 6, 25)
    xs = rng.uniform(6, w - 6, 25)
    amps = rng.uniform(200, 2000, 25)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = []
    for dy, dx in dith:
        f = np.full((h, w), 100.0)
        for sy, sx, a in zip(ys, xs, amps):
            f += a * np.exp(-((yy - sy - dy) ** 2 + (xx - sx - dx) ** 2)
                            / (2 * 1.3 ** 2))
        frames.append((f + rng.normal(0, 1.0, (h, w))).astype(np.float32))
    return frames, dith


@pytest.mark.parametrize("pixfrac", [0.7, 0.5])
def test_drizzle_stack_matches_jax(rng, pixfrac):
    """Default config (exact capped-list route) and pixfrac 0.5, which
    the auto-route sends to pre-averaging (1 + 0.5·2 ≤ 2)."""
    frames, _ = _star_frames(rng)
    want = jdz.drizzle_stack(frames, jdt.DrizzleConfig(pixfrac=pixfrac))
    got = tdz.drizzle_stack(frames, tdt.DrizzleConfig(pixfrac=pixfrac),
                            device=CPU)
    assert got.output_dims == want.output_dims == (128, 144)
    assert got.input_dims == want.input_dims
    assert got.frame_count == want.frame_count == 5
    assert got.output_scale == want.output_scale == 2.0
    np.testing.assert_allclose(np.asarray(got.offsets),
                               np.asarray(want.offsets), atol=1e-3)
    _close(got.image, want.image, 2e-4, 1e-6, "image")
    _close(got.weight_map, want.weight_map, 1e-5, 1e-6, "weights")
    assert got.rejected_pixels == want.rejected_pixels


def test_drizzle_stack_no_align_and_errors(rng):
    frames = [np.full((16, 16), 5.0, np.float32) for _ in range(3)]
    res = tdz.drizzle_stack(frames, tdt.DrizzleConfig(align=False),
                            device=CPU)
    assert res.output_dims == (32, 32)
    np.testing.assert_allclose(res.image.numpy()[4:-4, 4:-4], 5.0, atol=1e-3)
    from astroburst_tpu_torch.errors import InvalidInput
    with pytest.raises(InvalidInput):
        tdz.drizzle_stack(frames[:1], device=CPU)
    with pytest.raises(InvalidInput):
        tdz.drizzle_stack([np.ones((100, 100), np.float32),
                           np.ones((80, 100), np.float32)], device=CPU)


def _affine_frames(rng, n=3, h=160, w=176):
    """A star field bright and wide enough for the affine chain (60
    stars), frame k moved by sub-pixel dithers, rendered analytically."""
    dith = rng.uniform(-1.5, 1.5, (n, 2))
    dith[0] = 0.0
    ys = rng.uniform(12, h - 12, 60)
    xs = rng.uniform(12, w - 12, 60)
    amps = rng.uniform(400, 3000, 60)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = []
    for dy, dx in dith:
        f = np.full((h, w), 100.0)
        for sy, sx, a in zip(ys, xs, amps):
            f += a * np.exp(-((yy - sy - dy) ** 2 + (xx - sx - dx) ** 2)
                            / (2 * 1.5 ** 2))
        frames.append((f + rng.normal(0, 1.5, (h, w))).astype(np.float32))
    return frames, dith


def _assert_drizzle_matches(got, want):
    """Offsets within 1e-3 px; image and rejected count at this file's
    tolerances. The weight map moves with the offsets: under the default
    config (scale 2, 2 × 2 taps) one frame's weight wy·wx at a pixel
    moves by at most 2·scale·|Δd| per tap (each per-axis overlap moves by
    scale·|Δd| and is at most 1), so the map gets 1e-5 + n·4·2·2·max|Δd|
    (the affine route's offsets differ from JAX's at f32 centroid
    rounding, a few 1e-6 px)."""
    d_off = np.abs(np.asarray(got.offsets) - np.asarray(want.offsets))
    assert d_off.max() <= 1e-3
    _close(got.image, want.image, 2e-4, 1e-6, "image")
    _close(got.weight_map, want.weight_map,
           1e-5 + got.frame_count * 16 * d_off.max(), 1e-6, "weights")
    assert got.rejected_pixels == want.rejected_pixels


def test_drizzle_stack_low_confidence_frame_takes_affine_route(rng):
    """A low-confidence frame takes the affine route, as in JAX. A
    constant frame fails the phase-correlation gate (confidence 0), and
    that frame alone goes to alignment/pair.estimate_offset(AFFINE);
    there the starless frame falls back to the identity."""
    frames, _ = _affine_frames(rng)
    frames[2] = np.full_like(frames[2], 7.0)
    cfg = (tdt.DrizzleConfig(), jdt.DrizzleConfig())
    got = tdz.drizzle_stack(frames, cfg[0], device=CPU)
    want = jdz.drizzle_stack(frames, cfg[1])
    assert got.offsets[2] == (0.0, 0.0)
    _assert_drizzle_matches(got, want)


@pytest.mark.parametrize("method", ["affine", "zncc"])
def test_drizzle_stack_affine_methods_match_jax(rng, method):
    """AFFINE and ZNCC send every frame to the affine route; its offsets
    recover the dithers."""
    frames, dith = _affine_frames(rng)
    got = tdz.drizzle_stack(frames, tdt.DrizzleConfig(
        alignment_method=tdt.AlignmentMethod(method)), device=CPU)
    want = jdz.drizzle_stack(frames, jdt.DrizzleConfig(
        alignment_method=jdt.AlignmentMethod(method)))
    _assert_drizzle_matches(got, want)
    np.testing.assert_allclose(np.asarray(got.offsets)[:, ::-1], dith,
                               atol=0.15)


def test_drizzle_taps_match_jax_vectors():
    """Per-axis tap vectors of every kernel, both forms, vectorized over
    frames, equal JAX's per-frame vectors (exp/sin within 1e-6)."""
    ds = np.float32([0.0, -0.37, 1.61, -2.2])
    for kern in KERNELS:
        jk, tk = jdt.DrizzleKernel(kern), tdt.DrizzleKernel(kern)
        for scale, pixfrac in ((2.0, 0.7), (1.5, 1.0), (3.0, 0.4)):
            half = pixfrac * scale * 0.5
            for exact in (True, False):
                taps, base = jdz._support_taps(scale, half, jk, exact)
                assert (taps, base) == tdz._support_taps(scale, half, tk,
                                                         exact)
                jf = jdz._axis_taps_exact if exact else jdz._axis_weights
                tf = tdz._axis_taps_exact if exact else tdz._axis_weights
                ti, tw = tf(37, 19, torch.from_numpy(ds), scale, half, tk,
                            taps, base)
                for k, d in enumerate(ds):
                    ref = jf(37, 19, jnp.float32(d), scale, half, jk, taps,
                             base)
                    for t, (ji, jw) in enumerate(ref):
                        np.testing.assert_array_equal(ti[k, t].numpy(),
                                                      np.asarray(ji))
                        np.testing.assert_allclose(tw[k, t].numpy(),
                                                   np.asarray(jw),
                                                   atol=1e-6, rtol=1e-6)


# ---- the one-launch route: per-row tap tables and the banded gather -------


@pytest.mark.parametrize("kern,scale,pixfrac", [
    ("square", 2.0, 0.7), ("gaussian", 2.0, 1.0), ("lanczos3", 1.5, 0.8)])
@pytest.mark.parametrize("row0", [0, 37])
def test_band_row_tables_equal_per_band_taps(kern, scale, pixfrac, row0):
    """One batched tap pass equals per-band ``_exact_taps`` calls bit
    for bit, band by band and row by row (28
    output rows in bands of 8: the last band is padded)."""
    d_ys = torch.tensor([0.0, -0.37, 1.61, -2.2])
    k = tdt.DrizzleKernel(kern)
    n, band_rows, out_rows = 4, 8, 28
    n_bands = -(-out_rows // band_rows)
    r0s = tdz._band_origins(n_bands, band_rows, row0, scale, CPU)
    iy, wys_t, taps = tdz._band_row_tables(14, d_ys, r0s, band_rows, scale,
                                           pixfrac, k)
    assert iy.dtype == torch.int32 and wys_t.dtype == torch.float32
    assert iy.shape == wys_t.shape == (n_bands * band_rows, n * taps)
    for b in range(n_bands):
        idy, wy = tdz._exact_taps(band_rows, 14, d_ys - r0s[b], scale,
                                  pixfrac, k)
        rows = slice(b * band_rows, (b + 1) * band_rows)
        assert torch.equal(iy[rows].T.reshape(n, taps, band_rows),
                           idy.to(torch.int32))
        assert torch.equal(wys_t[rows].T.reshape(n, taps, band_rows), wy)


@pytest.mark.parametrize("kern,n,row0", [
    ("square", 4, 0), ("gaussian", 4, 9), ("lanczos3", 4, 0),
    ("square", 20, 13), ("square", 130, 0)],
    ids=["square-depth8", "gaussian-depth8-row0", "lanczos3-depth8",
         "square-depth40-row0", "square-depth260"])
def test_one_launch_plain_equals_band_loop(rng, kern, n, row0):
    """``_drizzle_kernel_exact`` on the CPU (the one launch with the
    gather's plain version) against the JAX package's band loop on its
    XLA route at the same ``band_rows`` and ``row0_offset``, at
    ``test_drizzle_kernel_exact_matches_jax``'s tolerances (past 128
    frames the weights at ``test_exact_drizzle_above_128_frames_matches_
    jax``'s: sums of 520 weights); the depth
    min(2n, n·taps²) in each of the kernel's instances (registers,
    shared memory, the global scratch). The call computes 14 of the 28
    output rows from ``row0``, as a shard of the row-sharded drizzle."""
    stack = np.stack(_frames(rng, n, 14, 10))
    d_ys = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    d_xs = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    d_ys[0] = d_xs[0] = 0.0
    got = tdz._drizzle_kernel_exact(
        stack_from_numpy(stack, CPU), torch.from_numpy(d_ys),
        torch.from_numpy(d_xs), 2.0, 1.0, tdt.DrizzleKernel(kern), 14, 20,
        2.5, 3.0, 5, band_rows=4, row0_offset=row0)
    want = jdz._drizzle_kernel_exact(
        jnp.asarray(stack), jnp.asarray(d_ys), jnp.asarray(d_xs), 2.0, 1.0,
        jdt.DrizzleKernel(kern), 14, 20, 2.5, 3.0, 5, band_rows=4,
        use_pallas=False, row0_offset=row0)
    assert got[0].shape == got[1].shape == (14, 20)
    _close(got[0], want[0], 2e-4, 1e-6, f"{kern} image")
    _close(got[1], want[1], 1e-5, 1e-6 if n > 128 else 0.0,
           f"{kern} weights")
    assert _rej_ok(kern, got[2], want[2]), (kern, int(got[2]), int(want[2]))
    assert int(got[2]) > 0


def test_gather_banded_refuses_mismatched_tables():
    stack = torch.zeros((2, 4, 5))
    iy = torch.zeros((8, 4), dtype=torch.int32)
    wys_t = torch.zeros((8, 4))
    ix = torch.zeros((4, 10), dtype=torch.int32)
    wxs = torch.zeros((4, 10))
    ok = (stack, iy, wys_t, ix, wxs, 2, 4, 3.0, 3.0, 3)
    assert tdg.drizzle_gather_banded(*ok)[0].shape == (8, 10)
    for i, bad in ((1, iy[:7]), (2, wys_t[:, :3]), (3, ix[:3]),
                   (4, wxs[:, :9]), (5, 3), (0, stack[:, :, :, None])):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError, match="shapes do not match"):
            tdg.drizzle_gather_banded(*args)
    with pytest.raises(ValueError, match="cap"):
        tdg.drizzle_gather_banded(*ok[:6], 0, 3.0, 3.0, 3)
    meta = [t.to("meta") for t in ok[:5]]
    with pytest.raises(ValueError, match="device"):
        tdg.drizzle_gather_banded(*meta, *ok[5:])


def test_gather_banded_plain_refuses_out_of_plane_taps():
    """A table index outside the plane is never present, whatever its
    weight (the kernel refuses such an index too)."""
    stack = torch.ones((1, 4, 4))
    iy = torch.tensor([[-1, 0], [3, 4], [0, 1]], dtype=torch.int32)
    ix = iy.T.contiguous()
    img, wgt, rej = tdg.drizzle_gather_banded(stack, iy, torch.ones((3, 2)),
                                              ix, torch.ones((2, 3)), 2, 4,
                                              3.0, 3.0, 3)
    assert wgt.tolist() == [[1.0, 1.0, 2.0], [1.0, 1.0, 2.0],
                            [2.0, 2.0, 4.0]]
    assert img.tolist() == [[1.0] * 3] * 3 and int(rej.sum()) == 0


# ---- the parity drizzle (K9) ------------------------------------------------


def _parity_args(rng, n=4, h=14, w=20):
    """tests/test_reference_impl.py:276-284's case: NaN pixels, an
    outlier, negative and fractional offsets."""
    frames = [rng.normal(10, 1, (h, w)).astype(np.float32) for _ in range(n)]
    frames[1][7, 9] = 300.0
    frames[0][3, 4] = np.nan
    frames[2][10, 15] = np.nan
    offs = [(0.0, 0.0), (0.4, -0.25), (-0.3, 0.6), (1.2, 0.8)][:n]
    return (np.stack(frames), np.float32([-o[1] for o in offs]),
            np.float32([-o[0] for o in offs]))


@pytest.mark.parametrize("kern", KERNELS)
def test_drizzle_exact_parity_matches_jax(rng, kern):
    stack, d_ys, d_xs = _parity_args(rng)
    want = jdz.drizzle_exact_parity(
        jnp.asarray(stack), d_ys.tolist(), d_xs.tolist(), 2.0, 1.0,
        jdt.DrizzleKernel(kern), 28, 40, 3.0, 3.0, 3, interpret=True)
    ts = stack_from_numpy(stack, CPU)
    args = (ts, torch.from_numpy(d_ys), torch.from_numpy(d_xs), 2.0, 1.0,
            tdt.DrizzleKernel(kern), 28, 40, 3.0, 3.0, 3)
    got = tdz.drizzle_exact_parity(*args)
    assert want is not None and got is not None
    assert got[0].shape == got[1].shape == (28, 40)
    _close(got[0], want[0], 2e-4, 1e-6, f"{kern} image")
    _close(got[1], want[1], 1e-5, 0.0, f"{kern} weights")
    assert int(got[2]) == int(want[2]) > 0
    # the port's banded route at one band (no band offset): bit-equal
    band = tdz._drizzle_kernel_exact(*args, band_rows=28)
    for a, b in zip(got, band):
        assert torch.equal(a, b), kern
    with K.plain_versions():
        again = tdz.drizzle_exact_parity(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b), kern


def test_drizzle_exact_parity_bench_config_matches_jax(rng):
    """The bench configuration (scale 2, pixfrac 0.7, square, 5
    iterations: 2 taps a side) at 10 frames of 32 x 48, offsets in
    +-2 px."""
    stack = rng.normal(100, 8, (10, 32, 48)).astype(np.float32)
    d_ys = rng.uniform(-2, 2, 10).astype(np.float32)
    d_xs = rng.uniform(-2, 2, 10).astype(np.float32)
    kern = jdt.DrizzleKernel.SQUARE
    want = jdz.drizzle_exact_parity(jnp.asarray(stack), d_ys.tolist(),
                                    d_xs.tolist(), 2.0, 0.7, kern, 64, 96,
                                    3.0, 3.0, 5, interpret=True)
    got = tdz.drizzle_exact_parity(
        stack_from_numpy(stack, CPU), d_ys, d_xs, 2.0, 0.7,
        tdt.DrizzleKernel.SQUARE, 64, 96, 3.0, 3.0, 5)
    _close(got[0], want[0], 2e-4, 1e-6, "image")
    _close(got[1], want[1], 1e-5, 0.0, "weights")
    assert int(got[2]) == int(want[2])


def test_parity_plan_matches_jax_plan(rng):
    """Shifts equal to the JAX plan's; the full-grid weights, taken at
    each parity, equal its per-parity weight matrices."""
    d_ys = [0.0, -0.37, 1.61, -2.2]
    d_xs = [0.0, 0.52, -1.3, 1.9]
    for kern in KERNELS:
        want = jdz._plan_parity(9, 11, d_ys, d_xs, 2.0, 0.7,
                                jdt.DrizzleKernel(kern), 18, 22)
        got = tdz._plan_parity(9, 11, d_ys, d_xs, 2.0, 0.7,
                               tdt.DrizzleKernel(kern), 18, 22)
        assert got["s"] == want["s"] == 2 and got["taps"] == want["taps"]
        np.testing.assert_array_equal(got["s_row"].numpy(), want["s_row"])
        np.testing.assert_array_equal(got["s_col"].numpy(), want["s_col"])
        for p in range(2):
            np.testing.assert_allclose(got["wys_t"][p::2].numpy(),
                                       want["wy_mats"][p], atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_allclose(got["wxs"][:, p::2].numpy().T,
                                       want["wx_mats"][p], atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("case", ["scale_1.5", "not_scale_times_input",
                                  "span_over_32", "span_32"])
def test_drizzle_exact_parity_none_where_jax_none(rng, case):
    """None in exactly the cases of the JAX plan: a non-integer scale, an
    output that is not S x the input, shifts spread over more than 32 px
    (and a result at a spread of exactly 32)."""
    stack = rng.normal(10, 1, (2, 8, 8)).astype(np.float32)
    scale, out_r, out_c = 2.0, 16, 16
    d_ys, d_xs = [0.0, 0.3], [0.0, -0.2]
    if case == "scale_1.5":
        scale, out_r, out_c = 1.5, 12, 12
    elif case == "not_scale_times_input":
        out_r = 15
    elif case == "span_over_32":
        d_ys = [0.0, 33.0]
    else:
        d_xs = [0.0, 32.0]
    want = jdz.drizzle_exact_parity(
        jnp.asarray(stack), d_ys, d_xs, scale, 1.0, jdt.DrizzleKernel.SQUARE,
        out_r, out_c, 3.0, 3.0, 3, interpret=True)
    got = tdz.drizzle_exact_parity(
        stack_from_numpy(stack, CPU), d_ys, d_xs, scale, 1.0,
        tdt.DrizzleKernel.SQUARE, out_r, out_c, 3.0, 3.0, 3)
    assert (got is None) == (want is None)
    assert (got is None) == (case != "span_32")
    if got is not None:
        _close(got[0], want[0], 2e-4, 1e-6, "image")
        _close(got[1], want[1], 1e-5, 0.0, "weights")
        assert int(got[2]) == int(want[2])


def test_parity_plain_refuses_out_of_plane_taps():
    """A tap whose input index falls outside the plane is never present,
    whatever weight it is given (the kernel refuses the index too)."""
    stack = torch.ones((1, 4, 4))
    # tap 0 at index -1 for parity 0, 3 for parity 1; two taps per axis
    base = torch.tensor([[-1, 3]], dtype=torch.int32)
    wys_t = torch.ones((8, 2))
    wxs = torch.ones((2, 8))
    img, wgt, rej = tdg.drizzle_gather_finalize(stack, base, base, wys_t,
                                                wxs, 2, 4, 3.0, 3.0, 3)
    assert img.shape == (8, 8)
    assert float(wgt[0, 0]) == 1.0       # rows/cols -1, 0: one inside
    assert float(wgt[2, 2]) == 4.0       # rows/cols 0, 1: all inside
    assert float(wgt[1, 1]) == 1.0       # rows/cols 3, 4: one inside
    assert float(wgt[3, 3]) == 0.0       # rows/cols 4, 5: none
    assert float(img[3, 3]) == 0.0 and float(img[2, 2]) == 1.0
