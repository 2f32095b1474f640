"""Exact order statistics of large tensors in bounded memory.

``torch.sort`` of n values also returns n int64 indices and needs
double buffers for both: one sort of a 2 GiB cube's values peaked at
20 GiB on the card. Here the values are sorted a row of CHUNK at a time
into one [rows, CHUNK] buffer (``sorted_rows``; +inf past the valid
values), so the sort's scratch is one row's, and each rank is then
found by bisection over the 32-bit keys that order the f32 values
(``key``: the bits, with the magnitude bits of negative values
flipped): 32 rounds of one batched ``searchsorted`` over the rows,
counting the values at or below the midpoint's value. The result is
the k-th smallest value itself, bit for bit, as one sort would give it,
and nothing waits on the host.

Ranks at or past the valid count give +inf; callers mask them. A zero
of either sign is returned as +0.0 (the two compare equal).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

KEY_MIN = -0x7F800001   # the key of -inf
KEY_MAX = 0x7F800000    # the key of +inf
ROUNDS = 32             # KEY_MAX - KEY_MIN < 2**32
CHUNK = 1 << 24


def key_to_f32(k: torch.Tensor) -> torch.Tensor:
    """The f32 value of each int64 key in [KEY_MIN, KEY_MAX]."""
    bits = torch.where(k >= 0, k, k ^ 0x7FFFFFFF).to(torch.int32)
    return bits.view(torch.float32)


def sorted_rows(flat: torch.Tensor,
                prep: Callable[[torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """[rows, L] f32: ``prep`` of each CHUNK of 1-D ``flat`` (invalid
    values mapped to +inf by it), each row sorted ascending, the last
    row padded with +inf."""
    n = flat.numel()
    width = max(min(CHUNK, n), 1)
    rows = torch.full((-(-n // width) or 1, width), float("inf"),
                      dtype=torch.float32, device=flat.device)
    for i, p0 in enumerate(range(0, n, width)):
        seg = prep(flat[p0:p0 + width])
        rows[i, :seg.numel()] = torch.sort(seg).values
    return rows


def select_ranks(rows: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """The 0-based rank-``ks`` values ([R] int64) of ``sorted_rows``'
    values below +inf: for each rank, the smallest key whose value has
    more than k values at or below it."""
    lo = torch.full(ks.shape, KEY_MIN, dtype=torch.int64, device=rows.device)
    hi = torch.full(ks.shape, KEY_MAX, dtype=torch.int64, device=rows.device)
    for _ in range(ROUNDS):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = key_to_f32(mid)[None, :].expand(rows.shape[0], -1)
        count = torch.searchsorted(rows, v.contiguous(), right=True).sum(0)
        left = count > ks
        hi = torch.where(left, mid, hi)
        lo = torch.where(left, lo, torch.minimum(mid + 1, hi))
    v = key_to_f32(lo)
    return torch.where(v == 0.0, 0.0, v)


def rank_indices(count: torch.Tensor, fracs: Sequence[float]
                 ) -> torch.Tensor:
    """int64 [R] 0-based ranks floor(n · frac), capped at n − 1, with n
    the count in f32, as the reference and the JAX package take them
    (frac 0.5 gives floor(n / 2)); never below 0."""
    n = count.to(torch.float32)
    idx = [torch.floor(n / 2.0) if f == 0.5 else torch.minimum(
        torch.floor(n * torch.tensor(np.float32(f), device=n.device)),
        n - 1.0) for f in fracs]
    return torch.clamp(torch.stack(idx), min=0).to(torch.int64)
