"""The whole star-alignment chain as one device program with one host
fetch (counterpart of astroburst_tpu/alignment/fused_chain.py).

The host chain (`affine.align_channel_affine`) is the canonical
implementation of affine.rs:129-270: detect stars on both planes,
dedupe, build triangles, vote, greedy-match, RANSAC, sanity gates,
warp. Run stage by stage it fetches each device result to the host and
builds the triangles in numpy. Here every stage stays on the device and
the host fetches one small info vector; the warped plane never leaves
the device:

- detection: `affine.normalize_for_detection` and
  `star_detection._detect` (K10, K11), as the host chain runs them;
- dedupe: the reference's brightest-first 3 px greedy
  (star_detection.rs:215) over the 256 brightest valid candidates in a
  stable flux-descending order, the first 60 accepted kept
  (`dedupe_topk`, `csrc/chain_scan.cu`);
- triangles (affine.rs:279-318): the C(60, 3) vertex triples are a
  module constant, so the side lengths are three takes from one [60, 60]
  distance table; a 3-element min/max network sorts the sides, a stable
  3-rank network orders the vertices. They are in the layout K12 takes
  ([T, 2] ratios, [T, 3] vertices), in triple order: K12 sorts by its
  own r0 buckets and its votes do not depend on the order;
- votes: `vote_kernel.vote` (K12);
- greedy one-to-one pairing (affine.rs:320-384): repeated argmax with
  the lowest flat index among ties (`greedy_match`, `csrc/chain_scan.cu`);
- RANSAC (affine.rs:400-517): all 2000 hypotheses as dense f32 math in
  image-centre-normalised coordinates, with the host chain's hypothesis
  table `affine._RANSAC_U`; the affine and rigid results and the
  reference's sanity gates on the device, nested selects pick the
  surviving transform;
- warp: `affine._warp_direct` with the device parameters, the port's
  `warp_image` of the same transform bit for bit. The JAX package warps
  by its shear decomposition (`warp_shear`, a TPU workaround that the
  port does not port) inside a static rotation envelope; here
  ``envelope`` only sets info slot 10 as JAX computes it and never
  limits the warp (ROADMAP C38).

The phase-correlation fallback stays on the host: it runs only when
the star chain fails, which the info vector reports (affine.rs:258-270;
an algorithmic fallback, not a device one). Each plane's list is its own
60 brightest sources, as in the reference, so the chain needs the
channels' brightest sources to be largely the same. Across filters far
apart in wavelength they may not be: a short-wave plane whose brightest
are blue stars against a long-wave one whose brightest are red galaxies
shares too few triangles, and both the chain and the reference fall back.

On the card the wrappers launch the kernels, and a CPU tensor runs
their plain torch versions (``runtime/kernels.use_kernel``). Nothing
before the info fetch synchronises with the host: no ``.item()``,
``nonzero``, boolean-mask indexing or indexing by a 0-d tensor.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.alignment import affine as A
from astroburst_tpu_torch.alignment.vote_kernel import vote
from astroburst_tpu_torch.analysis import star_detection as SD
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import as_f32

STAR_CAP = 64          # star slots in the vote table (> TRIANGLE_STAR_LIMIT)
N_TRI_STARS = A.TRIANGLE_STAR_LIMIT   # 60
SCAN_CAP = 256         # candidates the dedupe walks (csrc/chain_scan.cu)
_MAX_CANDIDATES = 8192  # the dedupe kernel's sort keys fit shared memory

# static C(60,3) vertex triples, i < j < k
_TRIPLES = np.array(
    [(a, b, c) for a in range(N_TRI_STARS)
     for b in range(a + 1, N_TRI_STARS)
     for c in range(b + 1, N_TRI_STARS)], dtype=np.int64)
N_TRI = len(_TRIPLES)                        # 34220


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(triples [N_TRI, 3] i64, the RANSAC table [2000, 3] f32, the
    identity transform [6] f32) on ``device``, uploaded at its first
    use: a copy from host memory waits for the device, so the chain
    keeps its tables there and uploads nothing else."""
    return (torch.from_numpy(_TRIPLES).to(device),
            torch.from_numpy(A._RANSAC_U).to(device),
            torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=device))


def takes_fused_chain(plane: torch.Tensor) -> bool:
    """True where the affine alignment goes through this chain: planes on
    the CUDA device, the port's accelerator (the JAX package routes its
    TPU there). The one switch of the route in `alignment/pair`,
    `compose/rgb` and `api/compose`."""
    return plane.device.type == "cuda"


# --- the dedupe (csrc/chain_scan.cu: abt_dedupe_topk) ------------------------


def dedupe_topk_plain(packed: torch.Tensor):
    """Brightest-first 3 px greedy dedupe of the packed detection
    candidates (fused_chain.py:_dedupe_topk): ([2, N_TRI_STARS] f32 x
    and y rows, +inf in empty slots; 0-d i32 min(accepted, N_TRI_STARS)).

    The accept sequence of `_postprocess_packed` over the SCAN_CAP
    brightest valid candidates (a stable flux-descending order): a
    candidate is accepted unless it lies within 3 px of an earlier
    accept. The output differs from the full walk only if more than
    SCAN_CAP − N_TRI_STARS of those are 3 px duplicates. A torch loop,
    one step a candidate."""
    n_keep = N_TRI_STARS
    cys, cxs, fluxes = packed[0], packed[1], packed[2]
    valid = packed[8] > 0.5
    order = torch.sort(torch.where(valid, -fluxes, float("inf")),
                       stable=True).indices[:SCAN_CAP]
    ys = cys.index_select(0, order)
    xs = cxs.index_select(0, order)
    val = valid.index_select(0, order)
    n = ys.shape[0]
    acc = torch.zeros(n, dtype=torch.bool, device=packed.device)
    for i in range(n):
        dy = ys - ys[i]
        dx = xs - xs[i]
        clash = (acc & (dy * dy + dx * dx < 9.0)).any()
        acc[i] = val[i] & ~clash
    rank = torch.cumsum(acc.to(torch.int32), 0) - 1
    total = acc.sum(dtype=torch.int32)
    # the first n_keep accepts to their rank, the rest to a spare slot
    slot = torch.where(acc & (rank < n_keep), rank, n_keep).to(torch.int64)
    out = torch.full((2, n_keep + 1), float("inf"), dtype=torch.float32,
                     device=packed.device)
    out[0].scatter_(0, slot, xs)
    out[1].scatter_(0, slot, ys)
    return out[:, :n_keep].contiguous(), torch.clamp(total, max=n_keep)


def dedupe_topk(packed: torch.Tensor):
    """`dedupe_topk_plain`; one launch on the card."""
    if not K.use_kernel(packed, "dedupe_topk"):
        return dedupe_topk_plain(packed)
    K.require_cuda(packed, "packed", 2)
    k = packed.shape[1]
    if packed.shape[0] != 10 or not 1 <= k <= _MAX_CANDIDATES:
        raise ValueError(f"packed must be [10, k], 1 <= k <= "
                         f"{_MAX_CANDIDATES}; got {tuple(packed.shape)}")
    out = torch.empty((2, N_TRI_STARS), dtype=torch.float32,
                      device=packed.device)
    n = torch.empty((), dtype=torch.int32, device=packed.device)
    K.launch("abt_dedupe_topk", packed.data_ptr(), k, out.data_ptr(),
             n.data_ptr(), K.stream_handle(packed))
    dedupe_topk.launches += 1
    return out, n


dedupe_topk.launches = 0


# --- triangles (fused_chain.py:_device_triangles) ----------------------------


def _sort3(d0, d1, d2):
    lo01 = torch.minimum(d0, d1)
    hi01 = torch.maximum(d0, d1)
    s0 = torch.minimum(lo01, d2)
    s2 = torch.maximum(hi01, d2)
    s1 = torch.maximum(lo01, torch.minimum(hi01, d2))
    return s0, s1, s2


def device_triangles(xs: torch.Tensor, ys: torch.Tensor):
    """build_triangles (affine.rs:279-318) on the device: [60] star
    positions (+inf pads) → ratios [T, 2] f32 and vertices [T, 3] i32,
    T = C(60, 3), one row a vertex triple in triple order; the rows of
    a short side or a missing star have +inf ratios.

    A missing star masks itself: an +inf coordinate makes every side of
    its triangles +inf or NaN, which fails the keep test — the
    triangles the host never builds."""
    n = N_TRI_STARS
    dev = xs.device
    dx = xs[:, None] - xs[None, :]
    dy = ys[:, None] - ys[None, :]
    dist = torch.sqrt(dx * dx + dy * dy).reshape(-1)       # [n*n]
    ti, tj, tk = _constants(dev)[0].unbind(1)
    d_ij = torch.take(dist, ti * n + tj)
    d_jk = torch.take(dist, tj * n + tk)
    d_ik = torch.take(dist, ti * n + tk)
    s0, s1, s2 = _sort3(d_ij, d_jk, d_ik)
    keep = (s0 >= A.MIN_TRIANGLE_SIDE) & torch.isfinite(s2)
    ratios = torch.where(keep[:, None], torch.stack([s1 / s0, s2 / s0], 1),
                         float("inf"))
    # stable 3-rank by opposite side (ties by position, as the host's
    # stable argsort)
    opp = (d_jk, d_ik, d_ij)
    verts = (ti, tj, tk)
    ranks = []
    for p in range(3):
        r = torch.zeros_like(ti)
        for q in range(3):
            if q == p:
                continue
            lt = opp[q] < opp[p]
            eq = (opp[q] == opp[p]) & (q < p)
            r = r + (lt | eq).to(ti.dtype)
        ranks.append(r)
    v_sorted = []
    for slot in range(3):
        v = torch.zeros_like(ti)
        for p in range(3):
            v = v + torch.where(ranks[p] == slot, verts[p], 0)
        v_sorted.append(v)
    return ratios.contiguous(), torch.stack(v_sorted, 1).to(torch.int32)


# --- greedy pairing (csrc/chain_scan.cu: abt_greedy_match) --------------------


def greedy_match_plain(votes: torch.Tensor):
    """Greedy one-to-one pairs by descending votes (affine.rs:320-384;
    fused_chain.py:_greedy_match): repeated argmax over the [64, 64] i32
    table (the lowest flat index among ties, as the host's stable sweep)
    until the best is below MIN_VOTES, the winner's row and column then
    set to -1. Returns ref rows and target columns [64] i32 (0 past the
    count) and the 0-d i32 count. A torch loop, one step a pair."""
    dev = votes.device
    v = votes.reshape(-1).clone()
    cells = torch.arange(STAR_CAP * STAR_CAP, device=dev)
    slots = torch.arange(STAR_CAP, device=dev)
    ris = torch.zeros(STAR_CAP, dtype=torch.int32, device=dev)
    tis = torch.zeros(STAR_CAP, dtype=torch.int32, device=dev)
    cnt = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(STAR_CAP):
        idx = torch.argmax(v)
        ok = torch.take(v, idx) >= A.MIN_VOTES
        ri = torch.div(idx, STAR_CAP, rounding_mode="floor")
        ti = idx % STAR_CAP
        here = ok & (slots == cnt)
        ris = torch.where(here, ri.to(torch.int32), ris)
        tis = torch.where(here, ti.to(torch.int32), tis)
        kill = ok & ((torch.div(cells, STAR_CAP, rounding_mode="floor") == ri)
                     | (cells % STAR_CAP == ti))
        v = torch.where(kill, -1, v)
        cnt = cnt + ok.to(torch.int32)
    return ris, tis, cnt


def greedy_match(votes: torch.Tensor):
    """`greedy_match_plain`; one launch on the card."""
    if not K.use_kernel(votes, "greedy_match"):
        return greedy_match_plain(votes)
    K.require_cuda(votes, "votes", 2, torch.int32)
    if votes.shape != (STAR_CAP, STAR_CAP):
        raise ValueError(f"votes must be [{STAR_CAP}, {STAR_CAP}], got "
                         f"{tuple(votes.shape)}")
    dev = votes.device
    ris = torch.empty(STAR_CAP, dtype=torch.int32, device=dev)
    tis = torch.empty(STAR_CAP, dtype=torch.int32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    K.launch("abt_greedy_match", votes.data_ptr(), A.MIN_VOTES,
             ris.data_ptr(), tis.data_ptr(), cnt.data_ptr(),
             K.stream_handle(votes))
    greedy_match.launches += 1
    return ris, tis, cnt


greedy_match.launches = 0


# --- RANSAC (fused_chain.py:_solve3, _ransac_device) --------------------------


def _f32(x: float) -> float:
    return float(np.float32(x))


def _f32s(*xs: float) -> float:
    """The product of ``xs`` in f32, left to right (as the JAX program
    folds its f32 constants)."""
    p = np.float32(xs[0])
    for x in xs[1:]:
        p = p * np.float32(x)
    return float(p)


def _solve3(m11, m12, m13, m22, m23, m33, b1, b2, b3):
    """Symmetric 3×3 solve by adjugate; returns the solution and |det|."""
    c11 = m22 * m33 - m23 * m23
    c12 = m13 * m23 - m12 * m33
    c13 = m12 * m23 - m13 * m22
    det = m11 * c11 + m12 * c12 + m13 * c13
    c22 = m11 * m33 - m13 * m13
    c23 = m12 * m13 - m11 * m23
    c33 = m11 * m22 - m12 * m12
    safe = torch.where(torch.abs(det) < 1e-30, 1.0, det)
    x1 = (c11 * b1 + c12 * b2 + c13 * b3) / safe
    x2 = (c12 * b1 + c22 * b2 + c23 * b3) / safe
    x3 = (c13 * b1 + c23 * b2 + c33 * b3) / safe
    return x1, x2, x3, torch.abs(det)


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor, without a host fetch."""
    return t.index_select(0, i.reshape(1))[0]


def ransac_device(mx, my, mu, mv, mvalid, cnt, rows: int, cols: int,
                  method: str):
    """RANSAC (affine.rs:400-517 semantics, all 2000 hypotheses dense)
    on the device in image-centre-normalised coordinates, for f32
    conditioning.

    Inputs: ref x/y and target x/y [64] f32 with a validity mask and the
    0-d count. Returns (params [6] raw-pixel affine, ok, inliers,
    residual), each on the device."""
    s = _f32(1.0 / max(rows, cols))
    cx = _f32(cols / 2.0)
    cy = _f32(rows / 2.0)
    nx = (mx - cx) * s
    ny = (my - cy) * s
    nu = (mu - cx) * s
    nv = (mv - cy) * s

    min_sample = 3 if method == "affine" else 2
    u_tab = _constants(mx.device)[1][:, :min_sample]
    n = torch.clamp(cnt, min=1)
    idx = torch.minimum((u_tab * n.to(torch.float32)).to(torch.int32),
                        n - 1).to(torch.int64)                   # [I, s]
    fx, fy, fu, fv = (torch.take(a, idx) for a in (nx, ny, nu, nv))

    if method == "affine":
        x1, x2, x3 = fx.unbind(1)
        y1, y2, y3 = fy.unbind(1)
        det = (x1 * (y2 - y3) - y1 * (x2 - x3) + (x2 * y3 - x3 * y2))
        # the host gate (affine.py:ransac_affine) is |det| > 1e-9 in RAW
        # pixels; det is a 2-form, so it scales by s² under the
        # normalisation — gated in the same units, both paths reject the
        # same hypotheses near degeneracy
        h_ok = torch.abs(det) > _f32s(1e-9, s, s)
        safe = torch.where(h_ok, det, 1.0)

        def cramer(w1, w2, w3):
            d0 = w1 * (y2 - y3) - y1 * (w2 - w3) + (w2 * y3 - w3 * y2)
            d1 = x1 * (w2 - w3) - w1 * (x2 - x3) + (x2 * w3 - x3 * w2)
            d2 = (x1 * (y2 * w3 - y3 * w2) - y1 * (x2 * w3 - x3 * w2)
                  + w1 * (x2 * y3 - x3 * y2))
            return d0 / safe, d1 / safe, d2 / safe

        pa, pb, ptx = cramer(*fu.unbind(1))
        pc, pd, pty = cramer(*fv.unbind(1))
    else:
        rcx = fx.mean(1)
        rcy = fy.mean(1)
        tcx = fu.mean(1)
        tcy = fv.mean(1)
        drx = fx - rcx[:, None]
        dry = fy - rcy[:, None]
        dtx = fu - tcx[:, None]
        dty = fv - tcy[:, None]
        num = (drx * dty - dry * dtx).sum(1)
        den = (drx * dtx + dry * dty).sum(1)
        # the host gate is 1e-12 in raw px²; num and den are coordinate
        # products, so the gate scales by s²
        h_ok = (torch.abs(num) + torch.abs(den)) > _f32s(1e-12, s, s)
        theta = torch.atan2(num, den)
        pa = torch.cos(theta)
        pb = -torch.sin(theta)
        pc = torch.sin(theta)
        pd = pa
        ptx = tcx - pa * rcx - pb * rcy
        pty = tcy - pc * rcx - pd * rcy

    # inlier counts of every hypothesis at once: [I, 64]
    px = pa[:, None] * nx[None, :] + pb[:, None] * ny[None, :] + \
        ptx[:, None]
    py = pc[:, None] * nx[None, :] + pd[:, None] * ny[None, :] + \
        pty[:, None]
    ex = px - nu[None, :]
    ey = py - nv[None, :]
    err2 = ex * ex + ey * ey
    thr = _f32s(A.RANSAC_INLIER_PX, s)
    inl = (err2 < _f32s(thr, thr)) & mvalid[None, :]
    counts = torch.where(h_ok, inl.sum(1, dtype=torch.int32), -1)
    best = torch.argmax(counts)
    best_inl = torch.take(counts, best)
    w = _row(inl, best).to(torch.float32)

    # refit on the best hypothesis's inliers
    if method == "affine":
        sw = torch.sum(w)
        sx_ = torch.sum(w * nx)
        sy_ = torch.sum(w * ny)
        sxx = torch.sum(w * nx * nx)
        sxy = torch.sum(w * nx * ny)
        syy = torch.sum(w * ny * ny)
        ra, rb, rtx, adet = _solve3(
            sxx, sxy, sx_, syy, sy_, sw,
            torch.sum(w * nx * nu), torch.sum(w * ny * nu),
            torch.sum(w * nu))
        rc, rd, rty, _ = _solve3(
            sxx, sxy, sx_, syy, sy_, sw,
            torch.sum(w * nx * nv), torch.sum(w * ny * nv),
            torch.sum(w * nv))
        fit_ok = adet > 1e-12
    else:
        sw = torch.clamp(torch.sum(w), min=1.0)
        rcx = torch.sum(w * nx) / sw
        rcy = torch.sum(w * ny) / sw
        tcx = torch.sum(w * nu) / sw
        tcy = torch.sum(w * nv) / sw
        num = torch.sum(w * ((nx - rcx) * (nv - tcy) -
                             (ny - rcy) * (nu - tcx)))
        den = torch.sum(w * ((nx - rcx) * (nu - tcx) +
                             (ny - rcy) * (nv - tcy)))
        theta = torch.atan2(num, den)
        ra = torch.cos(theta)
        rb = -torch.sin(theta)
        rc = torch.sin(theta)
        rd = ra
        rtx = tcx - ra * rcx - rb * rcy
        rty = tcy - rc * rcx - rd * rcy
        fit_ok = torch.sum(w) >= 2.0

    ra = torch.where(fit_ok, ra, torch.take(pa, best))
    rb = torch.where(fit_ok, rb, torch.take(pb, best))
    rtx = torch.where(fit_ok, rtx, torch.take(ptx, best))
    rc = torch.where(fit_ok, rc, torch.take(pc, best))
    rd = torch.where(fit_ok, rd, torch.take(pd, best))
    rty = torch.where(fit_ok, rty, torch.take(pty, best))

    # residual of the refined transform over the best inlier set
    qx = ra * nx + rb * ny + rtx - nu
    qy = rc * nx + rd * ny + rty - nv
    dist = torch.sqrt(qx * qx + qy * qy)
    resid = torch.sum(w * dist) / torch.clamp(
        best_inl.to(torch.float32), min=1.0) / s

    # denormalise: A unchanged, t = c - A·c + t'/s
    tx = cx - (ra * cx + rb * cy) + rtx / s
    ty = cy - (rc * cx + rd * cy) + rty / s

    # acceptance gates (affine.rs:14-22 + the RANSAC thresholds)
    ratio_ok = (best_inl.to(torch.float32) /
                torch.clamp(cnt.to(torch.float32), min=1.0)
                ) >= A.MIN_INLIER_RATIO
    rot = torch.abs(torch.atan2(rc, ra)) <= _f32(np.deg2rad(
        np.float32(A.MAX_ROTATION_DEG)))
    sx_scale = torch.sqrt(ra * ra + rc * rc)
    sy_scale = torch.sqrt(rb * rb + rd * rd)
    ok = ((cnt >= (A.MIN_MATCHES_AFFINE if method == "affine"
                   else A.MIN_MATCHES_RIGID)) &
          (best_inl >= A.MIN_MATCHES_RIGID) & ratio_ok &
          (resid <= A.MAX_RESIDUAL_PX) &
          (torch.abs(tx) <= cols * A.MAX_OFFSET_FRACTION) &
          (torch.abs(ty) <= rows * A.MAX_OFFSET_FRACTION) &
          rot & (sx_scale >= A.MIN_SCALE) & (sx_scale <= A.MAX_SCALE) &
          (sy_scale >= A.MIN_SCALE) & (sy_scale <= A.MAX_SCALE))
    params = torch.stack([ra, rb, tx, rc, rd, ty])
    return params, ok, best_inl, resid


# --- the chain ---------------------------------------------------------------


def _bucket(m: int) -> int:
    """The pad width rounded up to a power of two, at least 8
    (warp_shear.py:_bucket, for the envelope test of info slot 10)."""
    b = 8
    while b < m:
        b *= 2
    return b


def _envelope(envelope: float, rows: int, cols: int):
    """(m_v, m_h, nbits_v, nbits_h) of the JAX package's static shear
    pads for ``envelope`` (fused_chain.py:align_and_warp)."""
    span_v = envelope * max(cols - 1, 1)
    span_h = envelope * max(rows - 1, 1)
    return (_bucket(int(span_v) + 4), _bucket(int(span_h) + 4),
            max(int(span_v) + 1, 1).bit_length(),
            max(int(span_h) + 1, 1).bit_length())


def _detect_device(plane: torch.Tensor, max_peaks: int):
    """normalise → background → detect → dedupe-top60 (fused_chain.py:
    _detect_device): ([2, 60] x/y rows, 0-d count)."""
    rows, cols = plane.shape
    with trace.span("alignment.affine.detect"):
        packed = SD._detect(A.normalize_for_detection(plane),
                            SD._tile_size(rows, cols), A.DETECTION_SIGMA,
                            max_peaks)
        return dedupe_topk(packed)


def _chain_body(ref_stars: "RefStars", tgt: torch.Tensor, envelope: float):
    """Everything after the reference's detection (fused_chain.py:
    _chain_body): detect the target, triangles, vote, greedy match,
    RANSAC ×2, gates, warp. Returns (warped plane, info [13] f32: a, b,
    tx, c, d, ty, method (2 affine, 1 rigid, 0 failed), matched,
    inliers, residual, envelope ok, reference stars, target stars)."""
    rows, cols = tgt.shape
    txy, tn = _detect_device(tgt, ref_stars.max_peaks)
    with trace.span("alignment.affine.match"):
        txs, tys = txy.unbind(0)
        tr, tv = device_triangles(txs, tys)
        votes = vote(ref_stars.ratios, ref_stars.verts, tr, tv)
        ris, tis, cnt = greedy_match(votes)
        mvalid = torch.arange(STAR_CAP, device=tgt.device) < cnt
        mx = torch.where(mvalid, torch.take(ref_stars.xs, ris.long()), 0.0)
        my = torch.where(mvalid, torch.take(ref_stars.ys, ris.long()), 0.0)
        mu = torch.where(mvalid, torch.take(txs, tis.long()), 0.0)
        mv = torch.where(mvalid, torch.take(tys, tis.long()), 0.0)

        pa_aff, ok_aff, inl_aff, res_aff = ransac_device(
            mx, my, mu, mv, mvalid, cnt, rows, cols, "affine")
        pa_rig, ok_rig, inl_rig, res_rig = ransac_device(
            mx, my, mu, mv, mvalid, cnt, rows, cols, "rigid")

        use_aff = ok_aff
        use_rig = ~ok_aff & ok_rig
        method = torch.where(use_aff, 2, torch.where(use_rig, 1, 0))
        identity = _constants(tgt.device)[2]
        params = torch.where(use_aff, pa_aff, torch.where(use_rig, pa_rig,
                                                          identity))

        # info slot 10: the JAX package's shear-envelope test (reported
        # only)
        m_v, m_h, nbits_v, nbits_h = _envelope(envelope, rows, cols)
        a_, b_, _, c_, _, _ = params.unbind()
        q = c_ / torch.where(torch.abs(a_) < 1e-6, _f32(1e-6), a_)
        span_v = torch.abs(q) * (cols - 1)
        span_h = torch.abs(b_) * (rows - 1)
        env_ok = ((torch.abs(a_) >= _f32(1e-3)) & (span_v <= m_v - 4) &
                  (span_h <= m_h - 4) & (span_v < 2.0 ** nbits_v - 1) &
                  (span_h < 2.0 ** nbits_h - 1))

    with trace.span("alignment.affine.warp"):
        warped = A._warp_direct(tgt, params, rows, cols)

    inliers = torch.where(use_aff, inl_aff, torch.where(use_rig, inl_rig, 0))
    resid = torch.where(use_aff, res_aff, torch.where(use_rig, res_rig, 0.0))
    info = torch.cat([params, torch.stack([
        method.to(torch.float32), cnt.to(torch.float32),
        inliers.to(torch.float32), resid, env_ok.to(torch.float32),
        ref_stars.n.to(torch.float32), tn.to(torch.float32)])])
    return warped, info


class RefStars:
    """The reference channel's stars (positions and triangle
    descriptors) on the device, detected once and reused for every
    target aligned to the same reference: compose aligns G and B to R.

    ``xs``, ``ys``: [60] f32 (+inf in empty slots); ``n``: 0-d i32;
    ``ratios``: [T, 2] f32 and ``verts``: [T, 3] i32, K12's layout;
    ``shape``: the plane's (rows, cols); ``max_peaks``."""

    __slots__ = ("xs", "ys", "n", "ratios", "verts", "shape", "max_peaks")

    def __init__(self, xs, ys, n, ratios, verts, shape, max_peaks):
        self.xs, self.ys, self.n = xs, ys, n
        self.ratios, self.verts = ratios, verts
        self.shape = tuple(shape)
        self.max_peaks = max_peaks


def detect_ref_stars(reference, max_peaks: int = SD.MAX_PEAKS, *,
                     device: Optional[torch.device] = None) -> RefStars:
    """Detect and describe the reference channel's stars on the device,
    for reuse through ``align_and_warp(..., ref_stars=...)``. The plane
    goes to ``device`` (default: its own device for a tensor, else
    ``cuda_device()``); nothing is fetched."""
    ref = as_f32(reference, device)
    xy, n = _detect_device(ref, max_peaks)
    with trace.span("alignment.affine.match"):
        ratios, verts = device_triangles(xy[0], xy[1])
    return RefStars(xy[0], xy[1], n, ratios, verts, ref.shape, max_peaks)


def _check_ref_stars(ref_stars: RefStars, shape, max_peaks: int) -> None:
    if ref_stars.shape != tuple(shape) or ref_stars.max_peaks != max_peaks:
        raise ValueError("ref_stars were detected for shape "
                         f"{ref_stars.shape}/max_peaks="
                         f"{ref_stars.max_peaks}; got {tuple(shape)}/"
                         f"{max_peaks}")


def align_and_warp(reference, target, envelope: float = 0.035,
                   max_peaks: int = SD.MAX_PEAKS,
                   ref_stars: Optional[RefStars] = None, *,
                   device: Optional[torch.device] = None
                   ) -> Tuple[torch.Tensor, A.AffineAlignResult]:
    """Align ``target`` onto ``reference`` and warp it: one device
    program, one host fetch (the 13-slot info vector); the warped plane
    stays on the device. The planes go to ``device`` (default: the
    reference's device for a tensor, else ``cuda_device()``).

    ``envelope`` (0.035 ≈ ±2°) sets only info slot 10, the JAX
    package's shear-envelope flag: the warp here is direct and has no
    envelope (ROADMAP C38). Planes with a side below 16 or of another
    shape take the host chain (`align_channel_affine` + `warp_image`); a
    failed star chain takes the phase-correlation fallback
    (affine.rs:258-270). Pass ``ref_stars`` (from `detect_ref_stars`)
    to skip detecting the reference again."""
    ref = as_f32(reference, device)
    tgt = as_f32(target, ref.device)
    rows, cols = ref.shape
    if rows < 16 or cols < 16 or ref.shape != tgt.shape:
        res = A.align_channel_affine(ref, tgt)
        return A.warp_image(tgt, res.transform, rows, cols), res
    if ref_stars is None:
        ref_stars = detect_ref_stars(ref, max_peaks)
    else:
        _check_ref_stars(ref_stars, ref.shape, max_peaks)
    warped, info = _chain_body(ref_stars, tgt, envelope)
    with trace.span("alignment.affine.match"):
        info = info.tolist()          # the ONE host fetch
    return _interpret_info(info, ref, tgt, rows, cols, warped)


def _interpret_info(info: List[float], ref, tgt, rows, cols, warped):
    """The host's reading of one fetched info vector: the result record,
    a failed chain routed to the phase-correlation fallback
    (affine.rs:258-270 semantics), and a transform whose linear part is
    exactly the identity re-warped by `warp_image`'s separable shift."""
    method = int(info[6])
    trace.count("alignment.affine.star" if method else
                "alignment.affine.fallback")
    trace.count("alignment.affine.inliers", int(info[8]))
    if method == 0:
        res = A._fallback_phase_correlation(ref, tgt, rows, cols)
        return A.warp_image(tgt, res.transform, rows, cols), res
    t = A.AffineTransform(*info[:6])
    res = A.AffineAlignResult(t, int(info[7]), int(info[8]), info[9],
                              "affine" if method == 2 else "rigid")
    if A.is_translation(t):
        return A.warp_image(tgt, t, rows, cols), res
    return warped, res


def align_and_warp_many(reference, targets, envelope: float = 0.035,
                        max_peaks: int = SD.MAX_PEAKS,
                        ref_stars: Optional[RefStars] = None, *,
                        device: Optional[torch.device] = None) -> list:
    """Align EVERY target to ``reference`` with one host fetch of all
    their info vectors; returns ``(warped, AffineAlignResult)`` pairs in
    target order. Shapes the chain does not take go target by target
    through `align_and_warp`."""
    ref = as_f32(reference, device)
    tgts = [as_f32(t, ref.device) for t in targets]
    rows, cols = ref.shape
    if (not tgts or rows < 16 or cols < 16
            or any(t.shape != ref.shape for t in tgts)):
        return [align_and_warp(ref, t, envelope, max_peaks,
                               ref_stars=ref_stars)
                for t in tgts]
    if ref_stars is None:
        ref_stars = detect_ref_stars(ref, max_peaks)
    else:
        _check_ref_stars(ref_stars, ref.shape, max_peaks)
    outs = [_chain_body(ref_stars, t, envelope) for t in tgts]
    with trace.span("alignment.affine.match"):
        # the ONE fetch
        infos = torch.stack([i for _, i in outs]).tolist()
    return [_interpret_info(info, ref, t, rows, cols, w)
            for info, t, (w, _) in zip(infos, tgts, outs)]
