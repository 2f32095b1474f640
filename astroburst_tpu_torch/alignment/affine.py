"""Star-based affine channel alignment
(counterpart of astroburst_tpu/alignment/affine.py).

Reference: src-tauri/src/core/alignment/affine.rs — percentile
normalization, star detection at σ3.5 (top 120), triangle side-ratio
descriptors over the top 60 stars (min side 15 px), vote-based triangle
matching (tol 0.02), 2000-iteration RANSAC with 6-DOF affine (3×3
normal equations) or 4-DOF rigid (centroid + atan2) fits, sanity gates
(offset < 40% dim, rotation < 30°, scale ∈ [0.7, 1.4], residual < 5 px,
inliers ≥ 20%), and the fallback chain affine → rigid →
phase-correlation → identity.

On the device: normalization, star detection (kernels K10, K11) and the
triangle vote (kernel K12, alignment/vote_kernel.py); on the host, as in
the JAX package: triangles, greedy one-to-one matching and RANSAC (numpy
f64, the same seeded hypothesis table). The warp is the direct clamped
Catmull-Rom sampler of the JAX ``_warp_kernel`` (its ``exact=True``
form) in plain torch; a pure translation goes to ``shift_bicubic``. The
shear-decomposed and two-pass warps of the JAX package are TPU
workarounds and are not ported. ``align_channel_affine`` is the host
chain on every device; the device chain is alignment/fused_chain, which
``alignment/pair`` and the compose paths take on the card.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.alignment.phase_correlation import phase_correlate
from astroburst_tpu_torch.alignment.vote_kernel import (  # noqa: F401
    STAR_CAP, TRIANGLE_TOLERANCE, vote)
from astroburst_tpu_torch.analysis.star_detection import detect_stars_pair
from astroburst_tpu_torch.ops.resample import catmull_rom, shift_bicubic
from astroburst_tpu_torch.runtime.device import as_f32, cuda_device

_LOG = logging.getLogger("astroburst_tpu_torch.alignment")

MAX_STARS = 120
MIN_MATCHES_AFFINE = 6
MIN_MATCHES_RIGID = 4
RANSAC_ITERATIONS = 2000
RANSAC_INLIER_PX = 3.0
DETECTION_SIGMA = 3.5
MIN_TRIANGLE_SIDE = 15.0
MIN_VOTES = 1
MIN_INLIER_RATIO = 0.20
MAX_RESIDUAL_PX = 5.0
MAX_OFFSET_FRACTION = 0.40
MAX_ROTATION_DEG = 30.0
MIN_SCALE = 0.70
MAX_SCALE = 1.40
TRIANGLE_STAR_LIMIT = 60


@dataclass(frozen=True)
class AffineTransform:
    a: float = 1.0
    b: float = 0.0
    tx: float = 0.0
    c: float = 0.0
    d: float = 1.0
    ty: float = 0.0

    @staticmethod
    def identity() -> "AffineTransform":
        return AffineTransform()

    @staticmethod
    def translation(tx: float, ty: float) -> "AffineTransform":
        return AffineTransform(tx=tx, ty=ty)

    def map(self, x: float, y: float) -> Tuple[float, float]:
        return (self.a * x + self.b * y + self.tx,
                self.c * x + self.d * y + self.ty)

    def rotation_deg(self) -> float:
        return math.degrees(math.atan2(self.c, self.a))

    def scale_x(self) -> float:
        return math.hypot(self.a, self.c)

    def scale_y(self) -> float:
        return math.hypot(self.b, self.d)

    def as_tuple(self):
        return (self.a, self.b, self.tx, self.c, self.d, self.ty)


@dataclass
class AffineAlignResult:
    transform: AffineTransform
    matched_stars: int
    inliers: int
    residual_px: float
    method: str  # "affine" | "rigid" | "phase_correlation" | "identity"


# --- normalization (affine.rs:24-54) -----------------------------------------


def normalize_for_detection(image: torch.Tensor) -> torch.Tensor:
    """1st–99.9th percentile clamp-normalize on ~100k values sampled as
    whole rows; the image as it is when fewer than 100 samples are
    finite or their range is below 1e-15. The row index is computed in
    f32, as the JAX code computes it."""
    rows, cols = image.shape
    dev = image.device
    n_rows = max(min(-(-100_000 // cols), rows), 1)
    ridx = torch.clamp((torch.arange(n_rows, dtype=torch.float32, device=dev)
                        * torch.full((), rows / n_rows, dtype=torch.float32,
                                     device=dev)).to(torch.int64),
                       max=rows - 1)
    samples = image[ridx].reshape(-1)
    finite = torch.isfinite(samples)
    cnt = finite.sum()
    svals = torch.sort(torch.where(finite, samples, float("inf"))).values
    m = samples.shape[0]
    # torch.take: indexing by a 0-d tensor would fetch the index to the host
    lo = torch.take(svals, torch.clamp(
        torch.div(cnt, 100, rounding_mode="floor"), 0, m - 1))
    hi = torch.take(svals, torch.clamp(
        torch.div(cnt * 999, 1000, rounding_mode="floor"), 0, m - 1))
    rng = hi - lo
    ok = (cnt >= 100) & (rng >= 1e-15)
    norm = torch.clamp((image - lo) / torch.where(ok, rng, 1.0), 0.0, 1.0)
    return torch.where(ok, norm, image)


# --- triangles (affine.rs:279-318, host numpy, vectorized) -------------------


def build_triangles(stars: np.ndarray):
    """stars [S, 2] (x, y) → (vertex triples sorted by opposite side
    [T, 3], ratio descriptors [T, 2]); sides < 15 px filtered."""
    n = min(len(stars), TRIANGLE_STAR_LIMIT)
    if n < 3:
        return (np.zeros((0, 3), np.int32), np.zeros((0, 2), np.float32))
    pts = np.asarray(stars[:n], dtype=np.float64)
    ar = np.arange(n, dtype=np.int32)
    i, j, k = np.meshgrid(ar, ar, ar, indexing="ij")
    mask = (i < j) & (j < k)
    i, j, k = i[mask], j[mask], k[mask]
    diff = pts[:, None, :] - pts[None, :, :]
    dist = np.sqrt((diff * diff).sum(axis=2))
    d_ij = dist[i, j]
    d_jk = dist[j, k]
    d_ik = dist[i, k]
    sides = np.sort(np.stack([d_ij, d_jk, d_ik], axis=1), axis=1)
    keep = sides[:, 0] >= MIN_TRIANGLE_SIDE
    i, j, k = i[keep], j[keep], k[keep]
    sides = sides[keep]
    ratios = np.stack([sides[:, 1] / sides[:, 0],
                       sides[:, 2] / sides[:, 0]], axis=1).astype(np.float32)
    # vertices ordered by their opposite side length (affine.rs:386-398)
    opp = np.stack([d_jk[keep], d_ik[keep], d_ij[keep]], axis=1)
    order = np.argsort(opp, axis=1, kind="stable")
    verts = np.take_along_axis(np.stack([i, j, k], axis=1), order, axis=1)
    return verts.astype(np.int32), ratios


# --- triangle voting (kernel K12) + greedy pairing ---------------------------

# triangles from ≤ TRIANGLE_STAR_LIMIT = 60 stars are ≤ C(60,3) = 34220,
# padded to one fixed length as the JAX package pads them
TRI_CAP = -(-34220 // 256) * 256


def _pad_tris(verts: np.ndarray, ratios: np.ndarray):
    pad = TRI_CAP - len(verts)
    # +inf ratio rows can never be within tolerance of anything
    return (np.concatenate([verts, np.zeros((pad, 3), np.int32)]),
            np.concatenate([ratios,
                            np.full((pad, 2), np.inf, np.float32)]))


def match_triangles(ref_stars: np.ndarray, tgt_stars: np.ndarray, ref_tris,
                    tgt_tris, device: Optional[torch.device] = None
                    ) -> List[Tuple[float, float, float, float]]:
    """Vote table on ``device`` (default ``cuda_device()``), greedy
    one-to-one pairing on the host (affine.rs:320-384)."""
    ref_verts, ref_ratios = ref_tris
    tgt_verts, tgt_ratios = tgt_tris
    if len(ref_verts) == 0 or len(tgt_verts) == 0:
        return []
    dev = cuda_device() if device is None else device
    args = [torch.from_numpy(a).to(dev) for a in
            (*_pad_tris(ref_verts, ref_ratios)[::-1],
             *_pad_tris(tgt_verts, tgt_ratios)[::-1])]
    votes = vote(*args).cpu().numpy().astype(np.int64)

    flat = votes.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    used_ref = np.zeros(STAR_CAP, bool)
    used_tgt = np.zeros(STAR_CAP, bool)
    matches = []
    for idx in order:
        v = flat[idx]
        if v < max(MIN_VOTES, 1):  # padded rows/cols carry zero votes
            break
        ri, ti = divmod(int(idx), STAR_CAP)
        if used_ref[ri] or used_tgt[ti]:
            continue
        used_ref[ri] = True
        used_tgt[ti] = True
        matches.append((float(ref_stars[ri][0]), float(ref_stars[ri][1]),
                        float(tgt_stars[ti][0]), float(tgt_stars[ti][1])))
    return matches


# --- fits (affine.rs:519-642, host f64) --------------------------------------


def fit_affine(matches: np.ndarray) -> Optional[AffineTransform]:
    if len(matches) < 3:
        return None
    rx, ry, tx, ty = matches.T
    a = np.stack([rx, ry, np.ones_like(rx)], axis=1)
    ata = a.T @ a
    if abs(np.linalg.det(ata)) < 1e-12:
        return None
    sol_x = np.linalg.solve(ata, a.T @ tx)
    sol_y = np.linalg.solve(ata, a.T @ ty)
    return AffineTransform(a=sol_x[0], b=sol_x[1], tx=sol_x[2],
                           c=sol_y[0], d=sol_y[1], ty=sol_y[2])


def fit_rigid(matches: np.ndarray) -> Optional[AffineTransform]:
    if len(matches) < 2:
        return None
    rx, ry, tx, ty = matches.T
    rcx, rcy, tcx, tcy = rx.mean(), ry.mean(), tx.mean(), ty.mean()
    drx, dry = rx - rcx, ry - rcy
    dtx, dty = tx - tcx, ty - tcy
    num = float((drx * dty - dry * dtx).sum())
    den = float((drx * dtx + dry * dty).sum())
    theta = math.atan2(num, den)
    ct, st = math.cos(theta), math.sin(theta)
    return AffineTransform(a=ct, b=-st, tx=tcx - ct * rcx + st * rcy,
                           c=st, d=ct, ty=tcy - st * rcx - ct * rcy)


def _residual(matches: np.ndarray, t: AffineTransform) -> float:
    if len(matches) == 0:
        return 0.0
    rx, ry, tx, ty = matches.T
    px = t.a * rx + t.b * ry + t.tx
    py = t.c * rx + t.d * ry + t.ty
    return float(np.sqrt((px - tx) ** 2 + (py - ty) ** 2).mean())


# one fixed uniform table drives hypothesis sampling: idx = floor(u·n),
# the JAX package's table (same generator, seed and draws)
_RANSAC_U = np.random.default_rng(0xDEADBEEF).random(
    (RANSAC_ITERATIONS, 3)).astype(np.float32)


def ransac_affine(matches: List[Tuple[float, float, float, float]],
                  method: str) -> Optional[AffineAlignResult]:
    """All 2000 hypotheses vectorized; deterministic (affine.rs:400-517)."""
    m = np.asarray(matches, dtype=np.float64)
    n = len(m)
    min_sample = 3 if method == "affine" else 2
    if n < min_sample:
        return None
    idx = np.minimum((_RANSAC_U[:, :min_sample] * n).astype(np.int64), n - 1)
    # degenerate samples (repeated points) yield singular fits → dropped
    rx, ry = m[idx, 0], m[idx, 1]          # [I, s]
    tx, ty = m[idx, 2], m[idx, 3]

    if method == "affine":
        ones = np.ones_like(rx)
        a_mats = np.stack([rx, ry, ones], axis=2)          # [I, 3, 3]
        dets = np.linalg.det(a_mats)
        ok = np.abs(dets) > 1e-9
        a_ok = a_mats[ok]
        sol_x = np.linalg.solve(a_ok, tx[ok][..., None])[..., 0]
        sol_y = np.linalg.solve(a_ok, ty[ok][..., None])[..., 0]
        params = np.zeros((ok.sum(), 6))
        params[:, 0:2] = sol_x[:, 0:2]
        params[:, 2] = sol_x[:, 2]
        params[:, 3:5] = sol_y[:, 0:2]
        params[:, 5] = sol_y[:, 2]
    else:
        rcx, rcy = rx.mean(1), ry.mean(1)
        tcx, tcy = tx.mean(1), ty.mean(1)
        drx, dry = rx - rcx[:, None], ry - rcy[:, None]
        dtx, dty = tx - tcx[:, None], ty - tcy[:, None]
        num = (drx * dty - dry * dtx).sum(1)
        den = (drx * dtx + dry * dty).sum(1)
        ok = (np.abs(num) + np.abs(den)) > 1e-12
        theta = np.arctan2(num[ok], den[ok])
        ct, st = np.cos(theta), np.sin(theta)
        params = np.stack([
            ct, -st, tcx[ok] - ct * rcx[ok] + st * rcy[ok],
            st, ct, tcy[ok] - st * rcx[ok] - ct * rcy[ok]], axis=1)

    if len(params) == 0:
        return None
    # inlier counting for every hypothesis at once: [Iok, n]
    px = (params[:, 0:1] * m[None, :, 0] + params[:, 1:2] * m[None, :, 1]
          + params[:, 2:3])
    py = (params[:, 3:4] * m[None, :, 0] + params[:, 4:5] * m[None, :, 1]
          + params[:, 5:6])
    err2 = (px - m[None, :, 2]) ** 2 + (py - m[None, :, 3]) ** 2
    inlier_masks = err2 < RANSAC_INLIER_PX ** 2
    counts = inlier_masks.sum(1)
    best = int(np.argmax(counts))
    best_inliers = int(counts[best])
    if best_inliers < MIN_MATCHES_RIGID:
        return None
    if best_inliers / n < MIN_INLIER_RATIO:
        return None
    inl = m[inlier_masks[best]]
    refined = (fit_affine(inl) if method == "affine" else fit_rigid(inl))
    if refined is None:
        p = params[best]
        refined = AffineTransform(a=p[0], b=p[1], tx=p[2], c=p[3], d=p[4],
                                  ty=p[5])
    res = _residual(inl, refined)
    if res > MAX_RESIDUAL_PX:
        return None
    return AffineAlignResult(refined, n, best_inliers, res, method)


# --- sanity + fallback chain (affine.rs:14-22, 183-270) ----------------------


def check_transform_sanity(result: AffineAlignResult, rows: int,
                           cols: int) -> Optional[str]:
    t = result.transform
    if abs(t.tx) > cols * MAX_OFFSET_FRACTION or \
            abs(t.ty) > rows * MAX_OFFSET_FRACTION:
        return "translation exceeds limit"
    if abs(t.rotation_deg()) > MAX_ROTATION_DEG:
        return "rotation exceeds limit"
    sx, sy = t.scale_x(), t.scale_y()
    if not (MIN_SCALE <= sx <= MAX_SCALE and MIN_SCALE <= sy <= MAX_SCALE):
        return "scale outside range"
    return None


def _fallback_phase_correlation(reference, target, rows,
                                cols) -> AffineAlignResult:
    pc = phase_correlate(reference, target)
    if (abs(pc.dx) > cols * MAX_OFFSET_FRACTION or
            abs(pc.dy) > rows * MAX_OFFSET_FRACTION or pc.confidence < 1.5):
        return AffineAlignResult(AffineTransform.identity(), 0, 0, 0.0,
                                 "identity")
    return AffineAlignResult(AffineTransform.translation(pc.dx, pc.dy),
                             0, 0, 0.0, "phase_correlation")


def align_channel_affine(reference, target,
                         device: Optional[torch.device] = None
                         ) -> AffineAlignResult:
    """Full chain: detect → triangles → vote → RANSAC affine → rigid →
    phase correlation → identity (affine.rs:129-270). The planes go to
    ``device`` (default: the reference's device for a tensor, else
    ``cuda_device()``). Fallback decisions are logged like the
    reference (affine.rs:141-207)."""
    ref = as_f32(reference, device)
    tgt = as_f32(target, ref.device)
    rows, cols = ref.shape

    ref_det, tgt_det = detect_stars_pair(normalize_for_detection(ref),
                                         normalize_for_detection(tgt),
                                         DETECTION_SIGMA)
    ref_stars = np.array([(s.x, s.y) for s in ref_det.stars[:MAX_STARS]])
    tgt_stars = np.array([(s.x, s.y) for s in tgt_det.stars[:MAX_STARS]])

    if len(ref_stars) < MIN_MATCHES_RIGID or \
            len(tgt_stars) < MIN_MATCHES_RIGID:
        _LOG.warning("affine: too few stars (ref=%d tgt=%d), falling back "
                     "to phase correlation", len(ref_stars), len(tgt_stars))
        return _fallback_phase_correlation(ref, tgt, rows, cols)

    ref_tris = build_triangles(ref_stars)
    tgt_tris = build_triangles(tgt_stars)
    if len(ref_tris[0]) == 0 or len(tgt_tris[0]) == 0:
        _LOG.warning("affine: no usable triangles, falling back to phase "
                     "correlation")
        return _fallback_phase_correlation(ref, tgt, rows, cols)

    matches = match_triangles(ref_stars, tgt_stars, ref_tris, tgt_tris,
                              ref.device)
    if len(matches) < MIN_MATCHES_RIGID:
        _LOG.warning("affine: %d star matches (< %d), falling back to "
                     "phase correlation", len(matches), MIN_MATCHES_RIGID)
        return _fallback_phase_correlation(ref, tgt, rows, cols)

    if len(matches) >= MIN_MATCHES_AFFINE:
        result = ransac_affine(matches, "affine")
        if result is not None:
            reason = check_transform_sanity(result, rows, cols)
            if reason is None:
                return result
            _LOG.warning("affine: transform rejected (%s), trying rigid",
                         reason)

    result = ransac_affine(matches, "rigid")
    if result is not None:
        reason = check_transform_sanity(result, rows, cols)
        if reason is None:
            return result
        _LOG.warning("affine: rigid transform rejected (%s)", reason)

    _LOG.warning("affine: star-based alignment failed, falling back to "
                 "phase correlation")
    return _fallback_phase_correlation(ref, tgt, rows, cols)


# --- warp (affine.rs:663-690) ------------------------------------------------


def _warp_direct(image: torch.Tensor, params: torch.Tensor, out_rows: int,
                 out_cols: int, row0: int = 0) -> torch.Tensor:
    """out[y, x] = Catmull-Rom 4×4 sample of ``image`` at (sy, sx) =
    T·(x, y), taps clamped to the plane; 0 where the source point falls
    outside [0, cols−1) × [0, rows−1) (the JAX ``_warp_kernel``).
    ``row0``: the output rows are [row0, row0 + out_rows) of the canvas
    (a row block of the sharded warp, parallel/warp.py)."""
    src_rows, src_cols = image.shape
    dev = image.device
    a, b, tx, c, d, ty = params.unbind()
    y = torch.arange(row0, row0 + out_rows, dtype=torch.float32,
                     device=dev)[:, None]
    x = torch.arange(out_cols, dtype=torch.float32, device=dev)[None, :]
    sx = a * x + b * y + tx
    sy = c * x + d * y + ty
    ix = torch.floor(sx)
    iy = torch.floor(sy)
    fx = sx - ix
    fy = sy - iy
    ix = ix.to(torch.int64)
    iy = iy.to(torch.int64)
    flat = image.reshape(-1)
    out = torch.zeros((out_rows, out_cols), dtype=torch.float32, device=dev)
    for j in range(4):
        wy = catmull_rom(fy - (j - 1))
        r = torch.clamp(iy + (j - 1), 0, src_rows - 1)
        row_val = torch.zeros_like(out)
        for i in range(4):
            wx = catmull_rom(fx - (i - 1))
            cc = torch.clamp(ix + (i - 1), 0, src_cols - 1)
            row_val = row_val + wx * flat[r * src_cols + cc]
        out = out + wy * row_val
    inside = (sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) & \
        (sy < src_rows - 1)
    return torch.where(inside, out, 0.0)


def is_translation(t: AffineTransform) -> bool:
    """True when the linear part is the identity (to 1e-12): the
    transform ``warp_image`` warps by the separable shift."""
    return (abs(t.a - 1.0) < 1e-12 and abs(t.d - 1.0) < 1e-12 and
            abs(t.b) < 1e-12 and abs(t.c) < 1e-12)


def warp_image(image, transform: AffineTransform, out_rows: int,
               out_cols: int) -> torch.Tensor:
    """Bicubic warp: out[y,x] = img(T·(x,y)); outside → 0. A pure
    translation onto the same canvas goes to the separable shift;
    everything else to the direct 2-D sampler (the JAX package's
    ``exact=True`` form). ``image`` stays on its device (a non-tensor
    goes to ``cuda_device()``)."""
    img = as_f32(image)
    t = transform
    if is_translation(t) and img.shape == (out_rows, out_cols):
        return shift_bicubic(img, t.ty, t.tx)
    params = torch.tensor(t.as_tuple(), dtype=torch.float32, device=img.device)
    return _warp_direct(img, params, out_rows, out_cols)
