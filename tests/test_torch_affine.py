"""PyTorch port: star-based affine alignment, the plain version of its
vote kernel (K12), the warp and alignment/pair against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the
JAX vote runs as its XLA form and as the Pallas kernel in interpret
mode. Tolerances:

- votes, triangles, RANSAC and the host fits: equal (integer counts;
  the same numpy code on the same f64 inputs);
- ``align_channel_affine``: the same method, matched count and inliers;
  transform parameters within 1e-3 (the star centroids differ at f32
  rounding, test_torch_star_detection.py);
- ``warp_image`` against the JAX direct sampler (``exact=True``):
  atol 1e-4 on a plane scaled to a peak of 1 (the warp is linear; the
  16 taps, some with negative weights, are summed in f32 in another
  order, so the difference scales with the values: at a pixel of 430
  the two differ by 1.5e-3, and the port is the closer to an f64
  evaluation, 3e-4 against JAX's 1.2e-3);
- the phase-correlation fallback compares with JAX's phase correlation
  run with its sub-pixel step held to the parabola vertex
  (``jax_parabola_vertex``, ROADMAP C8).

The CUDA vote kernel runs only on the card: chip_smoke.py holds it to
``vote_plain`` there. Here the plain forms of its counting sort and its
plan (``_bucket_rows``, ``_vote_plan``) hold every match, and
``_windowed_votes`` walks the plan's pieces as the kernel does: its
votes are equal to ``vote_plain``'s and to JAX's.
"""

import bisect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import dtypes as jdt
from astroburst_tpu.alignment import affine as ja
from astroburst_tpu.alignment import pair as jpair
from astroburst_tpu.alignment.vote_kernel import vote_pallas
from astroburst_tpu_torch import dtypes as tdt
from astroburst_tpu_torch.alignment import affine as ta
from astroburst_tpu_torch.alignment import pair as tpair
from astroburst_tpu_torch.alignment import vote_kernel as tvk
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _star_field(shape=(256, 256), n=40, seed=11, bg=50.0):
    """tests/test_affine.py:make_star_field."""
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, 1.5, shape)
    pts = rng.random((n, 2)) * (np.array(shape[::-1]) - 40) + 20
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    for x, y in pts:
        amp = 300 + rng.random() * 700
        img += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                            / (2 * 1.6 ** 2))
    return img.astype(np.float32)


def _invert(t):
    det = t.a * t.d - t.b * t.c
    ia, ib, ic, id_ = t.d / det, -t.b / det, -t.c / det, t.a / det
    return ja.AffineTransform(a=ia, b=ib, tx=-(ia * t.tx + ib * t.ty),
                              c=ic, d=id_, ty=-(ic * t.tx + id_ * t.ty))


def _moved(img, t):
    """target(T·p) = img(p), by the JAX package's warp."""
    return np.array(ja.warp_image(img, _invert(t), *img.shape))


def _rotation(deg, cx=128.0, cy=128.0):
    th = math.radians(deg)
    ct, st = math.cos(th), math.sin(th)
    return ja.AffineTransform(a=ct, b=-st, tx=cx - ct * cx + st * cy,
                              c=st, d=ct, ty=cy - st * cx - ct * cy)


def _tris(rng, n, shift=(7.0, -4.0)):
    stars_r = rng.random((n, 2)) * 2000
    stars_t = stars_r + np.array(shift) + rng.normal(0, 0.01, (n, 2))
    return ja.build_triangles(stars_r), ja.build_triangles(stars_t)


# ---- K12: the vote -------------------------------------------------------


VOTE_T = 640   # 2.5 blocks of the plan
VOTE_CASES = ("window_edges", "tied_r0", "all_equal_r0", "inf_nan_shuffled",
              "ids_outside", "one_live", "three_live", "no_live_ref")


@pytest.fixture(scope="module")
def vote_sets():
    """chip_smoke.py's adversarial triangle lists at VOTE_T rows."""
    import chip_smoke
    sets = chip_smoke.vote_cases(np.random.default_rng(41), VOTE_T)
    assert tuple(sets) == VOTE_CASES
    return {k: [torch.from_numpy(a) for a in v] for k, v in sets.items()}


def _pairs(rows_r, rows_t):
    """[refs, targets] bool: vote_plain's exact predicate on packed rows."""
    r = rows_r[:, :2].contiguous().view(torch.float32)
    t = rows_t[:, :2].contiguous().view(torch.float32)
    tol = tvk.TRIANGLE_TOLERANCE
    return ((torch.abs(r[:, None, 0] - t[None, :, 0]) <= tol)
            & (torch.abs(r[:, None, 1] - t[None, :, 1]) <= tol))


def _windowed_votes(rr, rv, tr, tv):
    """csrc/triangle_vote.cu in plain torch: the counting sort by r0
    bucket, the plan, and every piece of each ref block's window through
    the exact predicate (the kernel shares the pieces out over its grid
    in runs; each is walked once); a vertex outside [0, 64) casts no
    vote."""
    rrows, rst = tvk._bucket_rows(rr, rv)
    trows, tst = tvk._bucket_rows(tr, tv)
    lo, hi = (x.tolist() for x in tvk._vote_plan(rrows, rst, tst))
    votes = torch.zeros(tvk.STAR_CAP ** 2, dtype=torch.int64)
    for b in range(len(lo)):
        refs = rrows[b * tvk._BLOCK:(b + 1) * tvk._BLOCK]
        for j0 in range(lo[b], hi[b], tvk._PIECE):
            tgts = trows[j0:min(j0 + tvk._PIECE, hi[b])]
            ii, jj = _pairs(refs, tgts).nonzero(as_tuple=True)
            for q in range(2, 5):
                a, c = refs[ii, q].long(), tgts[jj, q].long()
                ok = ((a >= 0) & (a < tvk.STAR_CAP) & (c >= 0)
                      & (c < tvk.STAR_CAP))
                votes.index_add_(
                    0, (a * tvk.STAR_CAP + c)[ok],
                    torch.ones(int(ok.sum()), dtype=torch.int64))
    return votes.view(tvk.STAR_CAP, tvk.STAR_CAP).to(torch.int32)


def _buckets(rows):
    r = rows[:, :2].contiguous().view(torch.float32)
    k = torch.clamp(torch.floor(r[:, 0] * tvk._SCALE), 0, tvk._BUCKETS - 1)
    return torch.where(torch.isfinite(r).all(dim=1), k, tvk._BUCKETS)


@pytest.mark.parametrize("case", VOTE_CASES)
def test_vote_plan_windows_hold_every_match(vote_sets, case):
    """The rows are grouped by r0 bucket with the non-finite ones last;
    every (ref, target) pair that vote_plain's predicate matches lies in
    its ref block's planned window, and no window reaches into the
    non-finite tail of the targets."""
    rr, rv, tr, tv = vote_sets[case]
    rrows, rst = tvk._bucket_rows(rr, rv)
    trows, tst = tvk._bucket_rows(tr, tv)
    for rows, starts in ((rrows, rst), (trows, tst)):
        k = _buckets(rows)
        assert bool((k[1:] >= k[:-1]).all())
        assert starts.tolist() == [int((k < q).sum())
                                   for q in range(tvk._BUCKETS + 2)]
    lo, hi = tvk._vote_plan(rrows, rst, tst)
    assert lo.shape[0] == -(-VOTE_T // tvk._BLOCK)
    ii, jj = _pairs(rrows, trows).nonzero(as_tuple=True)
    # each match lies within the margin of its ref's bucket
    gap = (_buckets(trows)[jj] - _buckets(rrows)[ii]).abs()
    assert bool((gap <= tvk._margin()).all())
    b = ii // tvk._BLOCK
    assert bool((lo[b] <= jj).all()) and bool((jj < hi[b]).all())
    n_live = int(tst[tvk._BUCKETS])
    assert bool((hi <= n_live).all())
    live_blocks = -(-int(rst[tvk._BUCKETS]) // tvk._BLOCK)
    width = int((hi - lo).clamp(min=0).sum())
    if case == "no_live_ref":
        assert width == 0 and len(ii) == 0
    elif case == "all_equal_r0":   # every window is the whole list
        assert width == live_blocks * n_live
    elif case in ("tied_r0", "one_live"):   # r0 values far apart
        assert width < live_blocks * n_live


@pytest.mark.parametrize("case", VOTE_CASES)
def test_windowed_vote_equals_plain(vote_sets, case):
    args = vote_sets[case]
    want = tvk.vote_plain(*args)
    assert torch.equal(_windowed_votes(*args), want)
    assert torch.equal(tvk.vote(*args), want)   # the CPU route
    if case in ("window_edges", "tied_r0", "three_live", "one_live"):
        assert int(want.sum()) > 0


def test_vote_plain_matches_xla_kernel_at_full_t():
    (vr, rr), (vt, tr) = _tris(np.random.default_rng(0), 40)
    pv_r, pr_r = ja._pad_tris(vr, rr)
    pv_t, pr_t = ja._pad_tris(vt, tr)
    assert pr_r.shape[0] == ta.TRI_CAP == ja._TRI_CAP
    want = np.asarray(ja._vote_kernel(
        jnp.asarray(pr_r), jnp.asarray(pv_r), jnp.asarray(pr_t),
        jnp.asarray(pv_t), ja._STAR_CAP, ja._STAR_CAP))
    args = (_t(pr_r), torch.from_numpy(pv_r), _t(pr_t),
            torch.from_numpy(pv_t))
    got = tvk.vote(*args)
    assert got.dtype == torch.int32 and got.shape == (64, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) > 0
    np.testing.assert_array_equal(_windowed_votes(*args).numpy(), want)


def test_vote_plain_matches_vote_pallas_interpret():
    """T = 4096 (the Pallas kernel's 2048-multiple layout, transposed);
    both ratio sets shuffled with their padding."""
    rng = np.random.default_rng(3)
    (vr, rr), (vt, tr) = _tris(rng, 30, shift=(-3.0, 11.0))
    t = 4096

    def pad(v, r):
        v = np.concatenate([v, rng.integers(0, 64, (t - len(v), 3))
                            .astype(np.int32)])
        r = np.concatenate([r, np.full((t - len(r), 2), np.inf,
                                       np.float32)])
        order = rng.permutation(t)
        return v[order], r[order]

    vr, rr = pad(vr, rr)
    vt, tr = pad(vt, tr)
    want = np.asarray(vote_pallas(jnp.asarray(rr.T), jnp.asarray(vr.T),
                                  jnp.asarray(tr.T), jnp.asarray(vt.T),
                                  interpret=True))
    args = (_t(rr), torch.from_numpy(vr), _t(tr), torch.from_numpy(vt))
    np.testing.assert_array_equal(tvk.vote(*args).numpy(), want)
    np.testing.assert_array_equal(_windowed_votes(*args).numpy(), want)


def test_vote_ignores_vertices_outside_the_table():
    r = _t([[1.5, 2.0], [1.5, 2.0]])
    v = torch.tensor([[0, 1, 2], [70, 1, -1]], dtype=torch.int32)
    got = tvk.vote(r, v, r, v).numpy()
    # each ref row matches both target rows; out-of-table ids vote nowhere
    assert got[0, 0] == 1 and got[1, 1] == 4 and got[2, 2] == 1
    assert got.sum() == 6


def test_vote_rejects_other_devices():
    meta = torch.zeros((4, 2), device="meta")
    ids = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tvk.vote(meta, ids, meta, ids)


# ---- host stages ------------------------------------------------------------


def test_build_triangles_and_matching_equal_jax():
    rng = np.random.default_rng(3)
    ref = rng.random((30, 2)) * 400 + 20
    tgt = ref + np.array([7.0, -4.0])
    for stars in (ref, tgt, ref[:2], rng.random((70, 2)) * 900):
        for a, b in zip(ta.build_triangles(stars), ja.build_triangles(stars)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    rt, tt = ta.build_triangles(ref), ta.build_triangles(tgt)
    got = ta.match_triangles(ref, tgt, rt, tt, CPU)
    want = ja.match_triangles(ref, tgt, rt, tt)
    assert got == want and len(got) >= 20


@pytest.mark.parametrize("method", ["affine", "rigid"])
def test_ransac_and_fits_equal_jax(method):
    rng = np.random.default_rng(2)
    src = rng.random((30, 2)) * 300
    t = _rotation(1.5)
    dst = np.stack([t.a * src[:, 0] + t.b * src[:, 1] + t.tx + 4.0,
                    t.c * src[:, 0] + t.d * src[:, 1] + t.ty - 2.0], axis=1)
    dst[:6] += rng.random((6, 2)) * 80 + 20     # 20% outliers
    matches = [tuple(r) + tuple(d) for r, d in zip(src, dst)]
    got = ta.ransac_affine(matches, method)
    want = ja.ransac_affine(matches, method)
    assert (got.matched_stars, got.inliers, got.method) == \
        (want.matched_stars, want.inliers, want.method)
    assert got.transform.as_tuple() == want.transform.as_tuple()
    assert got.residual_px == want.residual_px
    m = np.asarray(matches)
    assert ta.fit_affine(m).as_tuple() == ja.fit_affine(m).as_tuple()
    assert ta.fit_rigid(m).as_tuple() == ja.fit_rigid(m).as_tuple()
    assert ta.ransac_affine(matches[:2], method) is None
    np.testing.assert_array_equal(ta._RANSAC_U, ja._RANSAC_U)


@pytest.mark.parametrize("shape", [(256, 256), (300, 257), (1000, 90)])
def test_normalize_for_detection_matches_jax(shape):
    """Row sampling in f32 (rows / n_rows is not an integer at these
    shapes), NaN pixels, and a plane too flat to normalize."""
    img = _star_field(shape, n=20, seed=4)
    img[5:9, 7:30] = np.nan
    want = np.asarray(ja.normalize_for_detection(jnp.asarray(img)))
    got = ta.normalize_for_detection(_t(img)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    flat = np.full(shape, 3.0, np.float32)
    np.testing.assert_array_equal(
        ta.normalize_for_detection(_t(flat)).numpy(), flat)


# ---- the chain --------------------------------------------------------------


CASES = {
    "translation": (35, 11, ja.AffineTransform(tx=6.0, ty=-8.0)),
    "rotation_2deg": (35, 9, _rotation(2.0)),
}


@pytest.mark.parametrize("case", list(CASES) + ["starless"])
def test_align_channel_affine_matches_jax(case):
    if case == "starless":
        rng = np.random.default_rng(4)
        ref = rng.normal(100, 2, (128, 128)).astype(np.float32)
        tgt = np.roll(ref, (4, 3), axis=(0, 1))
    else:
        n, seed, t = CASES[case]
        ref = _star_field((256, 256), n=n, seed=seed)
        tgt = _moved(ref, t)
    want = ja.align_channel_affine(ref, tgt)
    got = ta.align_channel_affine(ref, tgt, CPU)
    assert got.method == want.method
    assert (got.matched_stars, got.inliers) == (want.matched_stars,
                                                want.inliers)
    np.testing.assert_allclose(got.transform.as_tuple(),
                               want.transform.as_tuple(), atol=1e-3)
    if case == "starless":
        assert got.method in ("phase_correlation", "identity")
    else:
        assert got.method in ("affine", "rigid") and got.inliers >= 6


@pytest.mark.parametrize("t", [
    ja.AffineTransform(a=0.999, b=-0.035, tx=4.3, c=0.035, d=0.999,
                       ty=-2.7),
    ja.AffineTransform(a=1.1, b=0.02, tx=-6.0, c=-0.01, d=0.95, ty=3.5),
    ja.AffineTransform(tx=3.0, ty=2.0)])
def test_warp_image_matches_jax_direct_sampler(t):
    img = _star_field((64, 80), n=6)
    img /= img.max()
    img[30, 30] = np.nan
    want = np.asarray(ja.warp_image(img, t, 60, 84, exact=True))
    got = ta.warp_image(_t(img), ta.AffineTransform(*t.as_tuple()), 60,
                        84).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4)
    same = ta.warp_image(_t(img), ta.AffineTransform(tx=3.0, ty=2.0), 64, 80)
    np.testing.assert_allclose(same.numpy(), np.asarray(ja.warp_image(
        img, ja.AffineTransform(tx=3.0, ty=2.0), 64, 80)), rtol=1e-6)


def test_align_pair_matches_jax():
    ref = _star_field((256, 256), n=35, seed=9)
    tgt = _moved(ref, _rotation(1.0))
    got = tpair.align_pair(_t(ref), _t(tgt), tdt.AlignMethod.AFFINE, 256,
                           256)
    want = ja.align_channel_affine(ref, tgt)
    assert got.method_used == want.method
    assert got.inliers == want.inliers and got.confidence == 1.0
    np.testing.assert_allclose(got.offset, (want.transform.ty,
                                            want.transform.tx), atol=1e-3)
    t = ta.AffineTransform(*ta.align_channel_affine(
        _t(ref), _t(tgt)).transform.as_tuple())
    assert torch.equal(got.aligned, ta.warp_image(_t(tgt), t, 256, 256))
    dy, dx, conf = tpair.estimate_offset(_t(ref), _t(tgt),
                                         tdt.AlignMethod.AFFINE)
    assert (dy, dx, conf) == (*got.offset, 1.0)
    # phase correlation: the offsets of JAX's pair API
    shifted = np.roll(ref, (3, -5), axis=(0, 1))
    pc = tpair.align_pair_with_label(_t(ref), _t(shifted),
                                     tdt.AlignMethod.PHASE_CORRELATION, 256,
                                     256, "L")
    jpc = jpair.align_pair(ref, shifted, jdt.AlignMethod.PHASE_CORRELATION,
                           256, 256)
    np.testing.assert_allclose(pc.offset, jpc.offset, atol=1e-3)
    assert pc.method_used == "phase_correlation"
    np.testing.assert_allclose(pc.aligned.numpy(), np.asarray(jpc.aligned),
                               atol=1e-3)
