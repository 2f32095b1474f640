"""PyTorch port: the fused alignment chain (``alignment/fused_chain.py``)
against the JAX package's (astroburst_tpu/alignment/fused_chain.py), and
the routes of ``align_pair``, ``align_rgb_channels`` and the compose
align commands through it.

Inputs are made with numpy from a seed, as tests/test_fused_align.py
makes them; the JAX vote runs as the Pallas kernel in interpret mode
(JAX's own route off the TPU). Each JAX end-to-end reference is computed
once, in a module-scoped fixture. Tolerances, and why:

- the dedupe: bit-equal to JAX's ``_dedupe_topk`` on the same packed
  records (x, y and the count), and the plain loop bit-equal to a numpy
  mirror of ``csrc/chain_scan.cu``'s algorithm (rank by counting, the
  scan, the ballot prefix) on ``chip_smoke.chain_scan_cases``;
- the triangles: the same triangles, each with the same vertex order;
  the ratios within 1e-6 relative (measured 2.3e-7): XLA contracts
  dx*dx + dy*dy to an FMA on the CPU (ROADMAP C13), the port rounds
  both products;
- the votes and the greedy match: equal (integer counts; ties go to the
  lowest flat index on both sides);
- RANSAC: the same inlier count and ok flag; the parameters within
  RANSAC_ATOL of JAX's ``_ransac_device`` on the same inputs (f32 sums
  in another order and the contraction above; measured 1.8e-7 on the
  linear part and 6.5e-5 px on the translation, ROADMAP C39);
- end to end on 256² fields: the same method, matched count and
  inliers, the transform within 5e-3 (tests/test_fused_align.py's fused
  against host bound), and the warped plane bit-equal to the port's own
  ``warp_image`` of its transform (JAX warps by its shear decomposition,
  which the port does not port: ROADMAP C38);
- ``ref_stars``, many targets and the routes: bit-equal to the direct
  chain calls; JAX's reference stars carried across by
  ``convert.ref_stars_from_numpy`` give the result of the port's own
  triangles on the same positions, bit for bit.

On the card chip_smoke.py phase 4n holds the chain's two CUDA kernels to
their plain loops and the chain to its run under
``runtime.kernels.plain_versions()``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.alignment import affine as ja
from astroburst_tpu.alignment import fused_chain as JFC
from astroburst_tpu.alignment.vote_kernel import vote_pallas
from astroburst_tpu.analysis import star_detection as JSD
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import convert
from astroburst_tpu_torch import dtypes as td
from astroburst_tpu_torch.alignment import affine as ta
from astroburst_tpu_torch.alignment import fused_chain as FC
from astroburst_tpu_torch.alignment import pair as tpair
from astroburst_tpu_torch.alignment import vote_kernel as tvk
from astroburst_tpu_torch.compose import rgb as trgb
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_affine import _invert, _rotation, _star_field
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
RANSAC_ATOL = {"linear": 1e-5, "translation": 1e-3}


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _moved(img, t):
    """target(T·p) = img(p), by the JAX package's warp."""
    return np.array(ja.warp_image(img, _invert(t), *img.shape))


def _bits(a, b):
    a = torch.as_tensor(a).contiguous()
    b = torch.as_tensor(b).contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# ---- the dedupe (chain_scan.cu: abt_dedupe_topk) -------------------------


@pytest.fixture(scope="module")
def scan_cases():
    import chip_smoke
    return chip_smoke.chain_scan_cases(np.random.default_rng(61))


def _field_packed(seed):
    """JAX's detection record of a 256² star field of 60 stars
    (tests/test_fused_align.py:test_device_dedupe_matches_host)."""
    img = _star_field((256, 256), n=60, seed=seed)
    norm = ja.normalize_for_detection(jnp.asarray(img))
    return np.array(JSD._detect_fused(norm, 32, ja.DETECTION_SIGMA,
                                      JSD.MAX_PEAKS))


def _kernel_dedupe(packed):
    """csrc/chain_scan.cu's dedupe in numpy f32: the stable rank of
    (valid ? -flux : +inf) by counting (NaN last), the kScan first in
    shared memory, the scan with the separately rounded d², the ballot
    prefix."""
    k = packed.shape[1]
    valid = packed[8] > 0.5
    key = np.where(valid, -packed[2], np.float32(np.inf)).astype(np.float32)
    nan = np.isnan(key)
    with np.errstate(invalid="ignore"):
        less = (key[None, :] < key[:, None]) | (~nan[None, :] & nan[:, None])
        eq = (key[None, :] == key[:, None]) | (nan[None, :] & nan[:, None])
    before = np.arange(k)[None, :] < np.arange(k)[:, None]
    rank = (less | (before & eq)).sum(1)
    n = min(k, FC.SCAN_CAP)
    sy = np.zeros(FC.SCAN_CAP, np.float32)
    sx = np.zeros(FC.SCAN_CAP, np.float32)
    sv = np.zeros(FC.SCAN_CAP, bool)
    sel = rank < n
    sy[rank[sel]] = packed[0][sel]
    sx[rank[sel]] = packed[1][sel]
    sv[rank[sel]] = valid[sel]
    acc = np.zeros(FC.SCAN_CAP, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(n):
            if not sv[i]:
                continue
            dy = sy - sy[i]
            dx = sx - sx[i]
            clash = (acc & (dy * dy + dx * dx < np.float32(9.0))).any()
            acc[i] = not clash
    pos = np.cumsum(acc) - 1
    out = np.full((2, FC.N_TRI_STARS), np.inf, np.float32)
    keep = acc & (pos < FC.N_TRI_STARS)
    out[0, pos[keep]] = sx[keep]
    out[1, pos[keep]] = sy[keep]
    return out, min(int(acc.sum()), FC.N_TRI_STARS)


DEDUPE_CASES = ("field_3", "field_8", "dup_at_3px", "dup_heavy", "tied_flux",
                "three_stars", "none_valid", "all_valid")


def _packed_case(scan_cases, case):
    if case.startswith("field_"):
        return _field_packed(int(case.split("_")[1]))
    return scan_cases[0][case]


@pytest.mark.parametrize("case", DEDUPE_CASES)
def test_dedupe_equals_jax(scan_cases, case):
    """Bit-equal to JAX's ``_dedupe_topk`` on the same packed records,
    including more than 196 duplicates among the 256 brightest
    (``dup_heavy``: 20 accepted of 660 valid) and pairs at exactly 3 px
    (kept)."""
    packed = _packed_case(scan_cases, case)
    jx, jy, jn = (np.asarray(a) for a in JFC._dedupe_topk(
        jnp.asarray(packed)))
    xy, n = FC.dedupe_topk(torch.from_numpy(packed))
    assert int(n) == int(jn)
    assert _bits(xy[0], _t(jx)) and _bits(xy[1], _t(jy))
    if case == "dup_heavy":
        assert int(n) == 20
    if case == "dup_at_3px":
        assert int(n) == 60   # 80 accepted (pairs at 3 px), 60 kept


@pytest.mark.parametrize("case", DEDUPE_CASES + ("nonfinite_invalid",))
def test_dedupe_plain_equals_kernel_semantics(scan_cases, case):
    """The plain loop against the numpy mirror of the CUDA kernel, bit
    for bit; ``nonfinite_invalid`` (NaN/inf fluxes and coordinates on
    invalid slots) only here: JAX's one-hot matmul turns them into NaN."""
    packed = _packed_case(scan_cases, case)
    want, n_want = _kernel_dedupe(packed)
    xy, n = FC.dedupe_topk_plain(torch.from_numpy(packed))
    assert int(n) == n_want
    assert _bits(xy, torch.from_numpy(want))


# ---- triangles, votes, greedy match ---------------------------------------


def _stars(seed, n=45):
    rng = np.random.default_rng(seed)
    stars = (rng.random((n, 2)) * 400 + 20).astype(np.float32)
    xs = np.full(FC.N_TRI_STARS, np.inf, np.float32)
    ys = np.full(FC.N_TRI_STARS, np.inf, np.float32)
    xs[:n], ys[:n] = stars[:, 0], stars[:, 1]
    return xs, ys


@pytest.mark.parametrize("seed,n", [(5, 45), (6, 60), (7, 3)])
def test_device_triangles_equal_jax(seed, n):
    """Matched by vertex triple: the same triangles kept, the same vertex
    order, the ratios within 1e-6 relative (C13)."""
    xs, ys = _stars(seed, n)
    jr, jv = (np.asarray(a) for a in JFC._device_triangles(
        jnp.asarray(xs), jnp.asarray(ys)))
    ratios, verts = FC.device_triangles(_t(xs), _t(ys))
    assert ratios.shape == (FC.N_TRI, 2) and verts.dtype == torch.int32
    ratios, verts = ratios.numpy(), verts.numpy()
    fin = np.isfinite(ratios).all(1)
    jfin = np.isfinite(jr[0])
    assert fin.sum() == jfin.sum()
    got = {tuple(sorted(v)): (r, tuple(v))
           for r, v in zip(ratios[fin], verts[fin])}
    rel = 0.0
    for r, v in zip(jr.T[jfin], jv.T[jfin]):
        gr, gv = got.pop(tuple(sorted(v)))
        assert gv == tuple(v)
        rel = max(rel, float(np.max(np.abs(gr - r) / r)))
    assert not got
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("seed", [5, 6])
def test_votes_equal_jax(seed):
    """K12's plain version on the port's triangles against JAX's Pallas
    vote (interpret mode) on JAX's, for a shifted, jittered copy."""
    xs, ys = _stars(seed, 40)
    rng = np.random.default_rng(seed + 100)
    txs = (xs + 7.0 + rng.normal(0, 0.01, 60)).astype(np.float32)
    tys = (ys - 4.0 + rng.normal(0, 0.01, 60)).astype(np.float32)
    jargs = [JFC._device_triangles(jnp.asarray(a), jnp.asarray(b))
             for a, b in ((xs, ys), (txs, tys))]
    want = np.asarray(vote_pallas(*jargs[0], *jargs[1], interpret=True))
    rr, rv = FC.device_triangles(_t(xs), _t(ys))
    tr, tv = FC.device_triangles(_t(txs), _t(tys))
    got = tvk.vote_plain(rr, rv, tr, tv)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert int(got.diagonal().sum()) > 0


def _host_sweep(votes):
    """The host's stable sorted sweep (affine.py:match_triangles)."""
    flat = votes.reshape(-1)
    used_r = np.zeros(64, bool)
    used_t = np.zeros(64, bool)
    pairs = []
    for idx in np.argsort(-flat, kind="stable"):
        if flat[idx] < 1:
            break
        ri, ti = divmod(int(idx), 64)
        if used_r[ri] or used_t[ti]:
            continue
        used_r[ri] = used_t[ti] = True
        pairs.append((ri, ti))
    return pairs


MATCH_CASES = ("ties", "sparse", "all_equal", "zero", "three_cells", "cross",
               "random_7")


@pytest.mark.parametrize("case", MATCH_CASES)
def test_greedy_match_equals_jax(scan_cases, case):
    """Equal to JAX's ``_greedy_match`` and to the host's sweep (the
    kernel's rule: the lowest flat index among ties), ties included."""
    if case == "random_7":
        rng = np.random.default_rng(7)
        votes = rng.integers(0, 20, (64, 64)).astype(np.int32)
        votes[rng.random((64, 64)) < 0.7] = 0
    else:
        votes = scan_cases[1][case]
    jr, jt, jc = (np.asarray(a) for a in JFC._greedy_match(
        jnp.asarray(votes.astype(np.float32))))
    ris, tis, cnt = FC.greedy_match(torch.from_numpy(votes))
    assert int(cnt) == int(jc)
    np.testing.assert_array_equal(ris.numpy(), jr)
    np.testing.assert_array_equal(tis.numpy(), jt)
    sweep = _host_sweep(votes)
    assert list(zip(ris[:int(cnt)].tolist(), tis[:int(cnt)].tolist())) == \
        sweep


# ---- RANSAC ----------------------------------------------------------------


def _matches(seed=11, n=40, rows=512, cols=640):
    """tests/test_fused_align.py:test_ransac_device_matches_host's set."""
    rng = np.random.default_rng(seed)
    rx = rng.uniform(20, cols - 20, n)
    ry = rng.uniform(20, rows - 20, n)
    th = math.radians(0.8)
    ct, st = math.cos(th), math.sin(th)
    tx_ = ct * rx - st * ry + 6.0 + rng.normal(0, 0.05, n)
    ty_ = st * rx + ct * ry - 3.0 + rng.normal(0, 0.05, n)
    tx_[::13] += 40.0
    pad = FC.STAR_CAP - n
    return [np.pad(a, (0, pad)).astype(np.float32)
            for a in (rx, ry, tx_, ty_)]


@pytest.mark.parametrize("method", ["affine", "rigid"])
@pytest.mark.parametrize("n", [40, 5])
def test_ransac_equals_jax(method, n):
    rows, cols = 512, 640
    arrs = _matches(n=n)
    mvalid = np.arange(FC.STAR_CAP) < n
    jp, jok, jinl, jres = JFC._ransac_device(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(mvalid), jnp.int32(n),
        rows, cols, method)
    params, ok, inl, res = FC.ransac_device(
        *(_t(a) for a in arrs), torch.from_numpy(mvalid),
        torch.tensor(n, dtype=torch.int32), rows, cols, method)
    assert bool(ok) == bool(jok)
    assert int(inl) == int(jinl)
    d = np.abs(params.numpy().astype(np.float64) - np.asarray(jp, np.float64))
    assert d[[0, 1, 3, 4]].max() <= RANSAC_ATOL["linear"], d
    assert d[[2, 5]].max() <= RANSAC_ATOL["translation"], d
    assert abs(float(res) - float(jres)) <= 1e-3


# ---- end to end ------------------------------------------------------------


def _case_planes(case):
    if case == "translation":
        img = _star_field()
        return img, _moved(img, ja.AffineTransform(tx=6.0, ty=-8.0))
    if case == "rotation":
        img = _star_field(seed=9)
        return img, _moved(img, _rotation(2.0))
    rng = np.random.default_rng(4)
    a = rng.normal(100, 2, (128, 128)).astype(np.float32)
    return a, np.roll(a, (4, 3), axis=(0, 1))


E2E_CASES = ("translation", "rotation", "starless")


@pytest.fixture(scope="module")
def jax_e2e(jax_parabola_vertex):  # noqa: F811
    """JAX's fused chain on each case, once: (warped, result); and its
    reference stars of the translation case with the cached result."""
    out = {c: JFC.align_and_warp(*_case_planes(c)) for c in E2E_CASES}
    img, tgt = _case_planes("translation")
    stars = JFC.detect_ref_stars(img)
    out["cached"] = (stars, JFC.align_and_warp(img, tgt, ref_stars=stars))
    return out


def _same_result(a, b):
    return (a.method, a.matched_stars, a.inliers) == \
        (b.method, b.matched_stars, b.inliers)


@pytest.mark.parametrize("case", E2E_CASES)
def test_align_and_warp_equals_jax(jax_e2e, case):
    ref, tgt = (_t(p) for p in _case_planes(case))
    warped, res = FC.align_and_warp(ref, tgt)
    _, jres = jax_e2e[case]
    assert _same_result(res, jres), (res, jres)
    d = np.abs(np.subtract(res.transform.as_tuple(),
                           jres.transform.as_tuple())).max()
    assert d <= 5e-3, d
    assert _bits(warped, ta.warp_image(tgt, res.transform, *ref.shape))
    if case == "rotation":
        assert res.transform.rotation_deg() == pytest.approx(2.0, abs=0.2)
    if case == "starless":
        assert res.method in ("phase_correlation", "identity")


def test_align_and_warp_equals_host_chain():
    """The fused f32 chain within 5e-3 of the host chain's f64 RANSAC on
    the same planes, the same method and inliers (ROADMAP C40)."""
    for case in ("translation", "rotation"):
        ref, tgt = (_t(p) for p in _case_planes(case))
        _, res = FC.align_and_warp(ref, tgt)
        host = ta.align_channel_affine(ref, tgt)
        assert _same_result(res, host)
        assert np.abs(np.subtract(res.transform.as_tuple(),
                                  host.transform.as_tuple())).max() <= 5e-3


def test_ref_stars_cached_equals_direct(jax_e2e):
    """The port's own ``ref_stars`` give the direct call's result bit for
    bit; JAX's, carried across, that of the port's triangles on JAX's
    positions, and JAX's cached result within 5e-3."""
    img, tgt = (_t(p) for p in _case_planes("translation"))
    w_d, r_d = FC.align_and_warp(img, tgt)
    stars = FC.detect_ref_stars(img)
    w_c, r_c = FC.align_and_warp(img, tgt, ref_stars=stars)
    assert _same_result(r_c, r_d)
    assert r_c.transform.as_tuple() == r_d.transform.as_tuple()
    assert _bits(w_c, w_d)

    jstars, (_, jres) = jax_e2e["cached"]
    carried = convert.ref_stars_from_numpy(
        *(np.asarray(a) for a in (jstars.xs, jstars.ys, jstars.n,
                                  jstars.ratios_t, jstars.verts_t)),
        jstars.shape, jstars.max_peaks, CPU)
    assert carried.ratios.shape == (FC.N_TRI, 2)
    own = FC.RefStars(carried.xs, carried.ys, carried.n,
                      *FC.device_triangles(carried.xs, carried.ys),
                      carried.shape, carried.max_peaks)
    w_j, r_j = FC.align_and_warp(img, tgt, ref_stars=carried)
    w_o, r_o = FC.align_and_warp(img, tgt, ref_stars=own)
    assert _same_result(r_j, r_o)
    assert r_j.transform.as_tuple() == r_o.transform.as_tuple()
    assert _bits(w_j, w_o)
    assert _same_result(r_j, jres)
    assert np.abs(np.subtract(r_j.transform.as_tuple(),
                              jres.transform.as_tuple())).max() <= 5e-3


def test_ref_stars_mismatch_rejected():
    img = _t(_star_field(seed=5))
    stars = FC.detect_ref_stars(img)
    other = torch.zeros((128, 256))
    with pytest.raises(ValueError, match="ref_stars"):
        FC.align_and_warp(other, other, ref_stars=stars)
    with pytest.raises(ValueError, match="ref_stars"):
        FC.align_and_warp(img, img, max_peaks=512, ref_stars=stars)
    with pytest.raises(ValueError, match="ref_stars"):
        FC.align_and_warp_many(img, [img], max_peaks=512, ref_stars=stars)
    with pytest.raises(ValueError, match="ratios_t"):
        convert.ref_stars_from_numpy(
            np.zeros(60), np.zeros(60), 0, np.zeros((2, 100)),
            np.zeros((3, 100)), (256, 256), 1024, CPU)


def test_align_and_warp_many_equals_per_target():
    img = _star_field(seed=5)
    tgts = [_t(_moved(img, ja.AffineTransform(tx=4.0, ty=-3.0))),
            _t(_moved(img, _rotation(-1.0)))]
    img = _t(img)
    stars = FC.detect_ref_stars(img)
    singles = [FC.align_and_warp(img, t, ref_stars=stars) for t in tgts]
    many = FC.align_and_warp_many(img, tgts, ref_stars=stars)
    fresh = FC.align_and_warp_many(img, tgts)
    assert len(many) == len(fresh) == 2
    for (w_m, r_m), (w_f, r_f), (w_s, r_s) in zip(many, fresh, singles):
        for w, r in ((w_m, r_m), (w_f, r_f)):
            assert _same_result(r, r_s)
            assert r.transform.as_tuple() == r_s.transform.as_tuple()
            assert _bits(w, w_s)


def test_align_and_warp_shape_route():
    """Planes of another shape, or a side below 16, take the host chain
    (align_channel_affine + warp_image), target by target."""
    img = _t(_star_field(seed=5))
    small = img[:128, :128].contiguous()
    (w, r), = FC.align_and_warp_many(img, [small])
    host = ta.align_channel_affine(img, small)
    assert r == host
    assert _bits(w, ta.warp_image(small, host.transform, 256, 256))
    tiny = img[:12, :40].contiguous()
    w, r = FC.align_and_warp(tiny, tiny)
    assert r == ta.align_channel_affine(tiny, tiny)
    assert w.shape == (12, 40)
    assert FC.align_and_warp_many(img, []) == []


@pytest.fixture
def fetches(monkeypatch):
    """Counts the calls that bring a tensor's values to the host."""
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__", "nonzero"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


def test_one_host_fetch(fetches):
    img = _star_field(seed=5)
    tgts = [_t(_moved(img, _rotation(1.0))), _t(_moved(img, _rotation(-1.5)))]
    img = _t(img)
    stars = FC.detect_ref_stars(img)
    assert fetches == []
    fetches.clear()
    _, res = FC.align_and_warp(img, tgts[0])
    assert res.method == "affine" and not ta.is_translation(res.transform)
    assert fetches == ["tolist"]
    fetches.clear()
    out = FC.align_and_warp_many(img, tgts, ref_stars=stars)
    assert [r.method for _, r in out] == ["affine", "affine"]
    assert fetches == ["tolist"]


def test_wrappers_reject_other_devices():
    meta = torch.zeros((10, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        FC.dedupe_topk(meta)
    with pytest.raises(ValueError, match="device"):
        FC.greedy_match(torch.zeros((64, 64), dtype=torch.int32,
                                    device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FC.align_and_warp(np.zeros((64, 64), np.float32),
                              np.zeros((64, 64), np.float32))


# ---- the routes ------------------------------------------------------------


@pytest.fixture
def routed(monkeypatch):
    """The fused route taken on the CPU (the predicate patched), and the
    detections counted: [planes detected]."""
    monkeypatch.setattr(FC, "takes_fused_chain", lambda plane: True)
    return _count_detections(monkeypatch)


def _count_detections(monkeypatch):
    seen = []
    orig = FC._detect_device

    def counted(plane, *a, **kw):
        seen.append(tuple(plane.shape))
        return orig(plane, *a, **kw)
    monkeypatch.setattr(FC, "_detect_device", counted)
    return seen


@pytest.fixture(scope="module")
def rgb_planes():
    import tests.test_torch_compose as tc
    return [_t(p) for p in tc.affine_rgb()]


def test_align_pair_routes_to_the_fused_chain(routed, rgb_planes):
    ref, g, _ = rgb_planes
    res = tpair.align_pair(ref, g, td.AlignMethod.AFFINE, 256, 256)
    warped, direct = FC.align_and_warp(ref, g)
    assert res.method_used == direct.method == "affine"
    assert res.offset == (direct.transform.ty, direct.transform.tx)
    assert res.inliers == direct.inliers
    assert _bits(res.aligned, warped)
    assert routed == [(256, 256)] * 4
    # another canvas stays on the host chain
    routed.clear()
    other = tpair.align_pair(ref, g, td.AlignMethod.AFFINE, 300, 256)
    assert routed == [] and other.aligned.shape == (300, 256)


def test_align_rgb_channels_detects_the_reference_once(routed, rgb_planes):
    r, g, b = rgb_planes
    out = trgb.align_rgb_channels(r, g, b, 256, 256, td.AlignMethod.AFFINE)
    assert routed == [(256, 256)] * 3
    stars = FC.detect_ref_stars(r)
    (w_g, r_g), (w_b, r_b) = (FC.align_and_warp(r, t, ref_stars=stars)
                              for t in (g, b))
    assert _bits(out[1], w_g) and _bits(out[2], w_b)
    assert out[3] == (r_g.transform.ty, r_g.transform.tx)
    assert out[4] == (r_b.transform.ty, r_b.transform.tx)
    assert abs(abs(r_g.transform.rotation_deg()) - 0.4) < 0.1
    # one target: align_pair, which detects the reference itself
    routed.clear()
    one = trgb.align_rgb_channels(r, g, None, 256, 256,
                                  td.AlignMethod.AFFINE)
    assert routed == [(256, 256)] * 2 and _bits(one[1], w_g)


def _write_planes(tmp_path, planes):
    paths = []
    for name, p in zip("rgb", planes):
        path = str(tmp_path / f"{name}.fits")
        write_fits_mono(path, p.numpy(), HduHeader([("CRPIX1", "100.5"),
                                                    ("CRPIX2", "90.0")]))
        paths.append(path)
    return paths


def test_align_commands_detect_the_reference_once(routed, rgb_planes,
                                                  tmp_path):
    paths = _write_planes(tmp_path, rgb_planes)
    res = tapi.align_channels_cmd(paths, str(tmp_path / "out"), "affine",
                                  device=CPU)
    assert routed == [(256, 256)] * 3
    stars = FC.detect_ref_stars(rgb_planes[0])
    for ch, key, tgt in zip(res["channels"][1:], res["cache_keys"][1:],
                            rgb_planes[1:]):
        w, r = FC.align_and_warp(rgb_planes[0], tgt, ref_stars=stars)
        assert ch["method"] == r.method and ch["inliers"] == r.inliers
        assert ch["offset"] == [r.transform.ty, r.transform.tx]
        assert _bits(GLOBAL_IMAGE_CACHE.get(key, CPU).image, w)
    routed.clear()
    exp = tapi.export_aligned_channels_cmd(paths, str(tmp_path / "exp"),
                                           "affine", device=CPU)
    assert routed == [(256, 256)] * 3
    assert [c["offset"] for c in exp["channels"]] == \
        [[0.0, 0.0]] + [c["offset"] for c in res["channels"][1:]]


def test_host_chain_stays_off_the_card(monkeypatch, rgb_planes, tmp_path):
    """With the predicate left alone, CPU planes never reach the fused
    chain: align_pair, align_rgb_channels and the align commands give the
    host chain's results, as before."""
    seen = _count_detections(monkeypatch)
    ref, g, b = rgb_planes
    res = tpair.align_pair(ref, g, td.AlignMethod.AFFINE, 256, 256)
    host = ta.align_channel_affine(ref, g)
    assert res.offset == (host.transform.ty, host.transform.tx)
    assert _bits(res.aligned, ta.warp_image(g, host.transform, 256, 256))
    out = trgb.align_rgb_channels(ref, g, b, 256, 256, td.AlignMethod.AFFINE)
    assert out[3] == res.offset
    paths = _write_planes(tmp_path, rgb_planes)
    cmd = tapi.align_channels_cmd(paths, str(tmp_path / "out"), "affine",
                                  device=CPU)
    assert cmd["channels"][1]["offset"] == list(res.offset)
    assert seen == []
