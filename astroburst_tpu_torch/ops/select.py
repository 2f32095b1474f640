"""Exact global order statistics of large tensors in bounded memory.

``global_stats`` gives, for the finite non-zero values of a 1-D f32
tensor, their count, the median, the MAD (the median of the absolute
deviations from the median) and the 1% and 99.9% values, each the k-th
smallest value itself, bit for bit, at the ranks of ``rank_indices``,
as one f64 [5] tensor on the tensor's device.

On the card it launches ``csrc/radix_select.cu`` (header note there:
the bound and the design): histograms of the 32-bit keys that order
the f32 values, 11, 11 and 10 bits a pass, three passes over the
tensor in place for the three ranks of the values and three for the
MAD's, 12 launches with torch's ``rank_indices`` between the first and
the rest; nothing is sorted, nothing reaches the host, and the
workspace is 131 KB. On the CPU, and inside
``kernels.plain_versions()``, it runs the plain version,
``global_stats_plain``: the values sorted a row of CHUNK at a time into
one [rows, CHUNK] buffer (``sorted_rows``; +inf past the valid values),
so a sort's scratch is one row's, and each rank found by bisection over
the keys (``select_ranks``: 32 rounds of one batched ``searchsorted``
over the rows, counting the values at or below the midpoint's value).

The key of a value is its bits, with the magnitude bits of negative
values flipped (``key_to_f32`` is the inverse). Ranks at or past the
valid count give +inf; callers mask them. A zero of either sign is
returned as +0.0 (the two compare equal).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from astroburst_tpu_torch.runtime import kernels as K

KEY_MIN = -0x7F800001   # the key of -inf
KEY_MAX = 0x7F800000    # the key of +inf
ROUNDS = 32             # KEY_MAX - KEY_MIN < 2**32
CHUNK = 1 << 24
RANK_FRACS = (0.5, 0.01, 0.999)   # the median, the 1% and 99.9% values
# csrc/radix_select.cu's u64 words: the count, 3 × 4 rank slots, padding,
# then its six histograms (2048 + 3·2048 + 3·1024 + 2048 + 2048 + 1024)
WORKSPACE_WORDS = 16 + 16384


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


def global_stats_plain(flat: torch.Tensor) -> torch.Tensor:
    """``global_stats`` by chunked sorts and key bisection."""
    inf = float("inf")

    def valid(s):
        return torch.isfinite(s) & (s != 0.0)
    rows = sorted_rows(flat, lambda s: torch.where(valid(s), s, inf))
    cnt = torch.isfinite(rows).sum()
    ks = rank_indices(cnt, RANK_FRACS)
    med, low, high = select_ranks(rows, ks).unbind()
    del rows
    dev = sorted_rows(flat, lambda s: torch.where(valid(s),
                                                  torch.abs(s - med), inf))
    mad = select_ranks(dev, ks[:1])[0]
    return torch.stack([v.to(torch.float64)
                        for v in (cnt, med, mad, low, high)])


def global_stats(flat: torch.Tensor) -> torch.Tensor:
    """f64 [5] on ``flat``'s device: the count of the finite non-zero
    values of the 1-D f32 ``flat``, their median, MAD, and 1% and 99.9%
    values (the ranks of ``RANK_FRACS``; +inf for each when there is no
    such value)."""
    if not K.use_kernel(flat, "global_stats"):
        return global_stats_plain(flat)
    K.require_cuda(flat, "flat", 1)
    dev = flat.device
    ws = torch.zeros(WORKSPACE_WORDS, dtype=torch.int64, device=dev)
    out = torch.empty(5, dtype=torch.float64, device=dev)
    stream = K.stream_handle(flat)
    K.launch("abt_radix_count", flat.data_ptr(), flat.numel(), ws.data_ptr(),
             stream)
    ks = rank_indices(ws[0], RANK_FRACS)
    K.launch("abt_radix_select", flat.data_ptr(), flat.numel(), ks.data_ptr(),
             ws.data_ptr(), out.data_ptr(), stream)
    global_stats.launches += 1
    return out


global_stats.launches = 0
