"""K12: the triangle-descriptor vote table of the affine aligner.

Counterpart of astroburst_tpu/alignment/vote_kernel.py:``vote_pallas``
(and of the XLA form ``affine._vote_kernel``); the CUDA kernel is
``csrc/triangle_vote.cu`` (header note there: what bounds it and how it
is laid out). votes[a, b] counts the (ref triangle, target triangle)
pairs whose two side ratios agree within ``TRIANGLE_TOLERANCE`` and
whose p-th vertices are stars a and b, summed over p = 0, 1, 2, for
a, b < ``STAR_CAP`` (affine.rs:320-384). Inputs are ratios [T, 2] f32
and vertex ids [T, 3] i32, padded triangles with +inf ratios; the
result is [64, 64] i32.

The kernel votes over the r0 window only, as the TPU kernel skips the
block pairs whose ratio ranges lie apart. Its first launch sorts each
list on the device by counting, into buckets of 1/``_SCALE`` in r0
(non-finite rows last); the vote then gives each block of ``_BLOCK``
sorted refs the targets of the buckets within ``_margin()`` of its own,
cut into pieces of ``_PIECE`` that a persistent grid of ``_GRID``
blocks shares out in runs. ``_bucket_rows`` and ``_vote_plan`` are
that sort and that plan in plain torch (the CPU tests hold the plan to
every match). The window may be wider than the match set, never
narrower; the kernel applies the exact predicate, so its counts stay
exact.

The plain version is the one-hot contraction of affine.py:176-227 in
f32; the counts are exact integers (< 2^24) in both, so the two are
equal. ``vote`` launches the kernel for a CUDA tensor and runs
``vote_plain`` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K

TRIANGLE_TOLERANCE = 0.02
STAR_CAP = 64
_CHUNK = 256  # ref triangles per step of the plain contraction
_BLOCK = 256     # sorted refs per vote block (csrc/triangle_vote.cu)
_PIECE = 256     # targets staged per step of a window (csrc/triangle_vote.cu)
_GRID = 132 * 16  # blocks walking the pieces: 16 for each of 132 SMs
_MAX_REFS = 256 * _BLOCK  # the kernel plans at most 256 ref blocks
_SCALE = 128.0   # r0 buckets per unit (csrc/triangle_vote.cu)
_BUCKETS = 8192  # r0 in [0, 64); beyond, the edge buckets


def _one_hot(ids: torch.Tensor) -> torch.Tensor:
    """[n] vertex ids → [n, STAR_CAP] f32; an id outside the table has
    an all-zero row."""
    return (ids[:, None] == torch.arange(STAR_CAP, device=ids.device)
            ).to(torch.float32)


def vote_plain(ref_ratios: torch.Tensor, ref_verts: torch.Tensor,
               tgt_ratios: torch.Tensor, tgt_verts: torch.Tensor
               ) -> torch.Tensor:
    """[64, 64] i32 votes by the f32 one-hot contraction, in chunks of
    ref triangles (padded ones, with +inf ratios, match nothing and are
    dropped first)."""
    keep_r = torch.isfinite(ref_ratios).all(dim=1)
    keep_t = torch.isfinite(tgt_ratios).all(dim=1)
    rr, rv = ref_ratios[keep_r], ref_verts[keep_r]
    tr, tv = tgt_ratios[keep_t], tgt_verts[keep_t]
    ams = [torch.zeros((STAR_CAP, tr.shape[0]), dtype=torch.float32,
                       device=tr.device) for _ in range(3)]
    for c in range(0, rr.shape[0], _CHUNK):
        r = rr[c:c + _CHUNK]
        m = ((torch.abs(r[:, None, 0] - tr[None, :, 0]) <= TRIANGLE_TOLERANCE)
             & (torch.abs(r[:, None, 1] - tr[None, :, 1])
                <= TRIANGLE_TOLERANCE)).to(torch.float32)
        for p in range(3):
            ams[p] += _one_hot(rv[c:c + _CHUNK, p]).T @ m
    votes = sum(ams[p] @ _one_hot(tv[:, p]) for p in range(3))
    return torch.round(votes).to(torch.int32)


def _bucket_rows(ratios: torch.Tensor, verts: torch.Tensor):
    """(rows [T, 5] i32, starts [_BUCKETS + 2] i64): the list sorted by
    r0 bucket, floor(r0 · _SCALE) clipped to [0, _BUCKETS), each row r0,
    r1 (f32 bits) and the three vertex ids; a row with a non-finite ratio
    goes last (bucket _BUCKETS). starts[k] is the first row of bucket k.
    The kernel's counting sort gives the same buckets and starts; inside
    a bucket its order follows its atomics, and no count depends on it."""
    k = torch.clamp(torch.floor(ratios[:, 0] * _SCALE), 0, _BUCKETS - 1)
    k = torch.where(torch.isfinite(ratios).all(dim=1), k, _BUCKETS).long()
    rows = torch.cat([ratios.view(torch.int32), verts], dim=1)[
        torch.sort(k, stable=True).indices]
    starts = torch.cumsum(torch.bincount(k, minlength=_BUCKETS + 1), 0)
    return rows, torch.cat([starts.new_zeros(1), starts])


def _margin() -> int:
    """m: buckets that a match's r0 and t0 can lie apart. |r0 − t0| <= tol
    in f32 holds only if the real difference is at most tol (1 + 2^-23),
    so the buckets differ by at most floor(tol · _SCALE · (1 + 1e-6)) + 1
    (the f32 expression of the kernel)."""
    t = torch.tensor(TRIANGLE_TOLERANCE, dtype=torch.float32)
    return int(torch.floor(t * _SCALE * 1.000001)) + 1


def _vote_plan(ref_rows: torch.Tensor, ref_starts: torch.Tensor,
               tgt_starts: torch.Tensor):
    """(lo, hi) i64 [ceil(T_ref / _BLOCK)]: the kernel's plan. Sorted ref
    block b can match only the sorted targets [lo[b], hi[b]) — those of
    the buckets [k_lo − m, k_hi + m] around its first and last live
    ref's buckets (the least and the greatest); a block with no live ref
    has none. For a fixed r the t with fl(|r − t|) <= tol lie within m
    buckets of r's (the bucket is monotone in r0), so the window holds
    every match of the block's refs. The kernel cuts the windows into
    pieces of ``_PIECE`` that its grid shares out in runs."""
    n_live = int(ref_starts[_BUCKETS])
    nb = -(-ref_rows.shape[0] // _BLOCK)
    first = torch.arange(nb) * _BLOCK
    last = torch.clamp(first + _BLOCK, max=n_live) - 1
    r0 = ref_rows[:, 0].contiguous().view(torch.float32)

    def bucket(i):
        return torch.clamp(torch.floor(r0[i.clamp(0, max(n_live - 1, 0))]
                                       * _SCALE), 0, _BUCKETS - 1).long()
    m = _margin()
    lo = tgt_starts[torch.clamp(bucket(first) - m, min=0)]
    hi = tgt_starts[torch.clamp(bucket(last) + m + 1, max=_BUCKETS)]
    dead = first >= n_live
    return lo.masked_fill(dead, 0), hi.masked_fill(dead, 0)


def vote(ref_ratios: torch.Tensor, ref_verts: torch.Tensor,
         tgt_ratios: torch.Tensor, tgt_verts: torch.Tensor) -> torch.Tensor:
    """Triangle vote table [64, 64] i32."""
    if not K.use_kernel(ref_ratios, "vote"):
        return vote_plain(ref_ratios, ref_verts, tgt_ratios, tgt_verts)
    for t, name, cols, dtype in (
            (ref_ratios, "ref_ratios", 2, torch.float32),
            (ref_verts, "ref_verts", 3, torch.int32),
            (tgt_ratios, "tgt_ratios", 2, torch.float32),
            (tgt_verts, "tgt_verts", 3, torch.int32)):
        K.require_cuda(t, name, 2, dtype)
        if t.shape[1] != cols:
            raise ValueError(f"{name} must be [T, {cols}], got "
                             f"{tuple(t.shape)}")
    if ref_verts.shape[0] != ref_ratios.shape[0] or \
            tgt_verts.shape[0] != tgt_ratios.shape[0]:
        raise ValueError("ratios and vertices differ in length")
    if ref_ratios.data_ptr() % 8 or tgt_ratios.data_ptr() % 8:
        raise ValueError("ratios must be 8-byte aligned (read as float2)")
    t_ref, t_tgt = ref_ratios.shape[0], tgt_ratios.shape[0]
    if t_ref > _MAX_REFS:
        raise ValueError(f"{t_ref} ref triangles: the kernel takes at most "
                         f"{_MAX_REFS}")
    if t_ref == 0 or t_tgt == 0:
        return torch.zeros((STAR_CAP, STAR_CAP), dtype=torch.int32,
                           device=ref_ratios.device)
    votes = torch.empty((STAR_CAP, STAR_CAP), dtype=torch.int32,
                        device=ref_ratios.device)
    scratch = torch.empty(4 * (t_ref + t_tgt) + 2 * (_BUCKETS + 2),
                          dtype=torch.int32, device=ref_ratios.device)
    K.launch("abt_triangle_vote", ref_ratios.data_ptr(), ref_verts.data_ptr(),
             t_ref, tgt_ratios.data_ptr(), tgt_verts.data_ptr(), t_tgt,
             TRIANGLE_TOLERANCE, _GRID, scratch.data_ptr(), votes.data_ptr(),
             K.stream_handle(ref_ratios))
    vote.launches += 1
    return votes


vote.launches = 0
