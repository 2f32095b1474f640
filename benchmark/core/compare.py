"""The numbers that compare a run's outputs with the plain reference.

Each is a gap (0 when the two agree), so a limit is an upper bound.
A non-finite value where the reference has a finite one (or the other
way round) reads as an infinite gap.
"""

from __future__ import annotations

import math

import torch


def _gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    got = got.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    if got.shape != ref.shape:
        return torch.full((1,), math.inf, dtype=torch.float64)
    d = torch.abs(got - ref)
    same = (torch.isnan(got) & torch.isnan(ref)) | (got == ref)
    return torch.where(same, torch.zeros_like(d),
                       torch.where(torch.isfinite(d), d,
                                   torch.full_like(d, math.inf)))


def max_gap(got, ref, scale: float = 1.0) -> float:
    """The widest gap, in units of ``scale``."""
    return float(_gap(torch.as_tensor(got), torch.as_tensor(ref)).max()) \
        / scale


def mean_gap(got, ref, scale: float = 1.0) -> float:
    """The mean gap, in units of ``scale``."""
    return float(_gap(torch.as_tensor(got), torch.as_tensor(ref)).mean()) \
        / scale


def share_over(got, ref, tol: float) -> float:
    """The share of elements whose gap exceeds ``tol``."""
    return float((_gap(torch.as_tensor(got),
                       torch.as_tensor(ref)) > tol).double().mean())


def rel(got: float, ref: float) -> float:
    """|got - ref| / max(|ref|, 1e-30)."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - ref) / max(abs(ref), 1e-30)


def rel_count(got: int, ref: int) -> float:
    """|got - ref| / max(ref, 1) for counts."""
    return abs(int(got) - int(ref)) / max(int(ref), 1)
