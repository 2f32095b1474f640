"""K12: the triangle-descriptor vote table of the affine aligner.

Counterpart of astroburst_tpu/alignment/vote_kernel.py:``vote_pallas``
(and of the XLA form ``affine._vote_kernel``); the CUDA kernel is
``csrc/triangle_vote.cu`` (header note there: what bounds it and how it
is laid out). votes[a, b] counts the (ref triangle, target triangle)
pairs whose two side ratios agree within ``TRIANGLE_TOLERANCE`` and
whose p-th vertices are stars a and b, summed over p = 0, 1, 2, for
a, b < ``STAR_CAP`` (affine.rs:320-384). Inputs are ratios [T, 2] f32
and vertex ids [T, 3] i32, padded triangles with +inf ratios; the
result is [64, 64] i32. The TPU kernel's transposed layout, its
2048-multiple padding and its ratio-sorted block skip do not exist
here.

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
_SPLIT = 4    # target ranges per ref block (csrc/triangle_vote.cu)


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
    votes = torch.zeros((STAR_CAP, STAR_CAP), dtype=torch.int32,
                        device=ref_ratios.device)
    K.launch("abt_triangle_vote", ref_ratios.data_ptr(), ref_verts.data_ptr(),
             ref_ratios.shape[0], tgt_ratios.data_ptr(), tgt_verts.data_ptr(),
             tgt_ratios.shape[0], TRIANGLE_TOLERANCE, _SPLIT,
             votes.data_ptr(), K.stream_handle(ref_ratios))
    vote.launches += 1
    return votes


vote.launches = 0
