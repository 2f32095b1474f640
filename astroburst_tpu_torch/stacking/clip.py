"""Per-pixel sigma clip over the frame axis
(counterpart of astroburst_tpu/stacking/combine.py:sigma_clip_core and
of the clip in stacking/clip_kernel.py:_clip_body).

Per-pixel iterative clip (combine.rs:14-91): iteration 0 centres on the
median with sigma = max(MAD·1.4826, 1e-10), both at sorted index
cnt // 2 (select-nth, no even averaging); later iterations on mean and
sample std; asymmetric low/high bounds; a pixel is active while it
holds ≥ 2 values and its last pass removed something; the result is
the mean of the survivors, else the last finite centre, else 0. Values
take part iff finite (combine.rs:168-173). This is the plain version of
the clip half of kernel K3 (stacking/onepass_kernel.py).

Every sum over the frames adds them one after another in frame order,
from +0, as K3 does (``_frame_sum``): each pixel's arithmetic is then
its own, whatever the plane's shape. (``torch.sum`` over the frame
axis picks its order by the tensor's shape on the CPU, so a row slab of
a stack, parallel/pipeline.py, would round otherwise.)
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA


def _select_axis0(stack: torch.Tensor, mask: torch.Tensor,
                  rank: torch.Tensor) -> torch.Tensor:
    """Value at ascending index ``rank`` [H, W] of the masked values of
    ``stack`` [N, H, W] (masked-out values sort last as +inf)."""
    inf = torch.full_like(stack, float("inf"))
    svals = torch.sort(torch.where(mask, stack, inf), dim=0).values
    return torch.gather(svals, 0, rank[None].to(torch.int64))[0]


def _frame_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ_k x[k] over axis 0, in frame order from +0."""
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def sigma_clip_core(stack: torch.Tensor, sigma_low: float = 3.0,
                    sigma_high: float = 3.0, max_iter: int = 5):
    """Per-pixel sigma clip over axis 0 of [N, H, W].

    Returns (combined [H, W] f32, rejected: 0-d int64 tensor, the
    number of finite values that did not survive)."""
    finite = torch.isfinite(stack)
    count0 = finite.sum(dim=0)
    mask = finite
    stopped = torch.zeros(stack.shape[1:], dtype=torch.bool,
                          device=stack.device)
    last_center = torch.full(stack.shape[1:], float("nan"),
                             dtype=torch.float32, device=stack.device)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)

    for it in range(max_iter):
        cnt = mask.sum(dim=0)
        cntf = torch.clamp(cnt.to(torch.float32), min=1.0)
        if it == 0:
            center = _select_axis0(stack, mask, cnt // 2)
            mad = _select_axis0(torch.abs(stack - center), mask, cnt // 2)
            sigma = torch.clamp(mad * MAD_TO_SIGMA, min=1e-10)
        else:
            center = _frame_sum(torch.where(mask, stack, zero)) / cntf
            var = _frame_sum(torch.where(mask, (stack - center) ** 2,
                                         zero)) / torch.clamp(cntf - 1.0,
                                                              min=1.0)
            sigma = torch.clamp(torch.sqrt(var), min=1e-10)
        active = (cnt >= 2) & ~stopped
        dev = stack - center
        keep = (dev >= -sigma_low * sigma) & (dev <= sigma_high * sigma)
        new_mask = torch.where(active[None], mask & keep, mask)
        removed = cnt - new_mask.sum(dim=0)
        last_center = torch.where(active, center, last_center)
        stopped = stopped | (active & (removed == 0))
        mask = new_mask

    final_cnt = mask.sum(dim=0)
    mean_final = _frame_sum(torch.where(mask, stack, zero)) / torch.clamp(
        final_cnt.to(torch.float32), min=1.0)
    fallback = torch.where(torch.isfinite(last_center), last_center, zero)
    combined = torch.where(final_cnt > 0, mean_final, fallback)
    rejected = (count0 - final_cnt).sum()
    return combined, rejected
