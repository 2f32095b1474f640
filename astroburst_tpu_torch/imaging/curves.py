"""Levels and spline tone curves (counterpart of
astroburst_tpu/imaging/curves.py).

Reference: src-tauri/src/core/imaging/curves.rs — levels
(black/gamma/white), Fritsch–Carlson monotone cubic Hermite tone
curves baked into a 4096-entry LUT.

The JAX module evaluates the spline on the device by masked sums over
the segments, a workaround for the TPU's slow gathers. The port takes
the reference's own form (tests/reference_impl/curves.py
``ref_spline_lut``): the LUT is baked once on the host in f64 and
rounded to f32, then each pixel is one index gather,
``lut[floor(clip(v, 0, 1) · 4095)]`` in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

LUT_SIZE = 4096


@dataclass(frozen=True)
class LevelsParams:
    black: float = 0.0
    gamma: float = 1.0
    white: float = 1.0

    def is_identity(self) -> bool:
        return (abs(self.black) < 1e-7 and abs(self.gamma - 1.0) < 1e-7
                and abs(self.white - 1.0) < 1e-7)


def apply_levels(data: torch.Tensor, params: LevelsParams) -> torch.Tensor:
    """black/gamma/white levels; invalid (non-finite or < 0) → 0
    (curves.rs:31-52); the identity returns ``data`` itself."""
    if params.is_identity():
        return data
    rng = max(params.white - params.black, 1e-15)
    inv_gamma = 1.0 / min(max(params.gamma, 0.01), 10.0)
    black, inv_range, inv_g = torch.tensor(
        [params.black, 1.0 / rng, inv_gamma],
        dtype=torch.float32).to(data.device).unbind()
    norm = torch.clamp((data - black) * inv_range, 0.0, 1.0)
    out = torch.pow(norm, inv_g)
    return torch.where(torch.isfinite(data) & (data >= 0.0), out,
                       0.0).to(torch.float32)


def apply_levels_rgb(r, g, b, lr: LevelsParams, lg: LevelsParams,
                     lb: LevelsParams):
    return apply_levels(r, lr), apply_levels(g, lg), apply_levels(b, lb)


def fritsch_carlson_tangents(pts: np.ndarray) -> np.ndarray:
    """Monotone cubic Hermite tangents (curves.rs:112-156), host f64."""
    n = len(pts)
    if n < 2:
        return np.zeros(n)
    if n == 2:
        slope = (pts[1, 1] - pts[0, 1]) / max(pts[1, 0] - pts[0, 0], 1e-15)
        return np.array([slope, slope])
    dx = np.maximum(np.diff(pts[:, 0]), 1e-15)
    slopes = np.diff(pts[:, 1]) / dx
    m = np.zeros(n)
    m[0] = slopes[0]
    m[-1] = slopes[-1]
    for i in range(1, n - 1):
        if np.sign(slopes[i - 1]) != np.sign(slopes[i]):
            m[i] = 0.0
        else:
            m[i] = (slopes[i - 1] + slopes[i]) * 0.5
    for i in range(n - 1):
        if abs(slopes[i]) < 1e-15:
            m[i] = 0.0
            m[i + 1] = 0.0
            continue
        alpha = m[i] / slopes[i]
        beta = m[i + 1] / slopes[i]
        tau = alpha * alpha + beta * beta
        if tau > 9.0:
            s = 3.0 / np.sqrt(tau)
            m[i] = s * alpha * slopes[i]
            m[i + 1] = s * beta * slopes[i]
    return m


def _prepare_points(points: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Sort, dedup, anchor at (0,0)/(1,1) (curves.rs:71-83)."""
    pts = sorted(points, key=lambda p: p[0])
    dedup: List[Tuple[float, float]] = []
    for p in pts:
        if dedup and abs(p[0] - dedup[-1][0]) < 1e-9:
            continue
        dedup.append(tuple(p))
    if not dedup or dedup[0][0] > 1e-6:
        dedup.insert(0, (0.0, 0.0))
    if dedup[-1][0] < 1.0 - 1e-6:
        dedup.append((1.0, 1.0))
    return np.asarray(dedup, dtype=np.float64)


def is_identity_curve(points: Sequence[Tuple[float, float]]) -> bool:
    """curves.rs:96-107."""
    if len(points) > 2:
        return False
    if len(points) == 0:
        return True
    if len(points) == 1:
        return abs(points[0][0] - points[0][1]) < 1e-6
    near_start = abs(points[0][0]) < 1e-6 and abs(points[0][1]) < 1e-6
    near_end = (abs(points[1][0] - 1.0) < 1e-6 and
                abs(points[1][1] - 1.0) < 1e-6)
    return near_start and near_end


def _hermite_lut(pts: np.ndarray, tan: np.ndarray) -> np.ndarray:
    """The spline at t = i/4095, i = 0..4095, in f64, clamped to [0, 1]
    and rounded to f32 (curves.rs:70-92, 158-184): the segment of t is
    the last control point ≤ t, and t at or past the ends takes the end
    values."""
    t = np.arange(LUT_SIZE) / (LUT_SIZE - 1.0)
    n = len(pts)
    seg = np.clip(np.searchsorted(pts[:, 0], t, side="right") - 1, 0, n - 2)
    x0, y0 = pts[seg, 0], pts[seg, 1]
    x1, y1 = pts[seg + 1, 0], pts[seg + 1, 1]
    dx = np.maximum(x1 - x0, 1e-15)
    u = (t - x0) / dx
    u2, u3 = u * u, u * u * u
    h00 = 2.0 * u3 - 3.0 * u2 + 1.0
    h10 = u3 - 2.0 * u2 + u
    h01 = -2.0 * u3 + 3.0 * u2
    h11 = u3 - u2
    val = (h00 * y0 + h10 * dx * tan[seg] + h01 * y1
           + h11 * dx * tan[seg + 1])
    val = np.where(t <= pts[0, 0], pts[0, 1], val)
    val = np.where(t >= pts[n - 1, 0], pts[n - 1, 1], val)
    return np.clip(val, 0.0, 1.0).astype(np.float32)


class SplineCurve:
    """Monotone Hermite tone curve, baked into a 4096-entry f32 LUT."""

    def __init__(self, points: Sequence[Tuple[float, float]]):
        pts = _prepare_points(points)
        self.pts = pts
        self.tangents = fritsch_carlson_tangents(pts)
        self._lut = _hermite_lut(pts, self.tangents)

    def lut(self) -> np.ndarray:
        """The 4096-entry LUT (a copy)."""
        return self._lut.copy()

    def apply(self, data: torch.Tensor) -> torch.Tensor:
        """``lut[floor(clip(v, 0, 1) · 4095)]``; non-finite or negative
        → 0 (curves.rs:108)."""
        valid = torch.isfinite(data) & (data >= 0.0)
        v = torch.where(valid, data, 0.0)
        idx = torch.floor(torch.clamp(v, 0.0, 1.0) * (LUT_SIZE - 1.0))
        lut = torch.from_numpy(self._lut).to(data.device)
        out = lut[idx.to(torch.int64)]
        return torch.where(valid, out, 0.0)


def apply_curve(data: torch.Tensor, curve: SplineCurve) -> torch.Tensor:
    return curve.apply(data)


def apply_curve_rgb(r, g, b, cr: SplineCurve, cg: SplineCurve,
                    cb: SplineCurve):
    return cr.apply(r), cg.apply(g), cb.apply(b)
