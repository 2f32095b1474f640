"""Polynomial background extraction (counterpart of
astroburst_tpu/imaging/background.py).

Reference: src-tauri/src/core/imaging/background.rs — grid sampling
(3–32 cells/side) with per-cell medians, global sigma-clip retention of
cell medians, 2D polynomial fit of degree 1–5 (≤21 terms) via ridge-
regularized normal equations, model evaluation, subtract/divide with
the model median as the restored pedestal, RMS residual.

The split is JAX's: the cell medians, the model and the correction run
on the plane's device, and the host reads one packed row of the cell
medians, invalid fractions, counts and the global median and MAD
(background.py:97-101); the ≤ 1024-sample retention loop and the
≤ 21 × 21 normal-equation solve stay host f64 numpy (:187-245).
Plain torch: the JAX package computes all of it outside any Pallas
kernel. Differences from the JAX module:

- the cell medians are one ``torch.sort`` over the inner cells, with
  the two middle order statistics averaged (:67-102), as in JAX;
- the global median, its MAD and the model median are the one order
  statistic at sorted index cnt // 2 (the rank floor(n/2) + 1 of JAX's
  ``_median_pair``, :54-64, whose docstring says "even-averaging" but
  whose code selects one rank; ROADMAP C22), selected exactly
  (``ops/stats.select_half``) where JAX's compare-count
  ``masked_rank_values`` lies within range/8⁶ of it (ROADMAP C21);
- integer powers of the model's coordinates are the products
  ``lax.integer_pow`` forms (square and multiply), so the model differs
  from JAX's only where XLA contracts the sum of terms to FMAs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.ops.stats import select_half
from astroburst_tpu_torch.runtime.device import as_f32
from astroburst_tpu_torch.runtime.progress import ProgressHandle

MAX_POLY_TERMS = 21


@dataclass
class BackgroundConfig:
    grid_size: int = 8
    poly_degree: int = 3
    sigma_clip: float = 2.5
    iterations: int = 3
    mode: str = "subtract"  # "subtract" | "divide"


@dataclass
class BackgroundResult:
    model: torch.Tensor
    corrected: torch.Tensor
    sample_count: int
    rms_residual: float


def min_samples_for_degree(degree: int) -> int:
    n_terms = (degree + 1) * (degree + 2) // 2
    return n_terms + 2


def _cell_medians(image: torch.Tensor, grid: int, cell_h: int,
                  cell_w: int) -> torch.Tensor:
    """Per-cell inner-region medians + invalid fractions + counts +
    global median/MAD, packed into one f32 row
    (background.rs:117-190)."""
    margin_h = cell_h // 4
    margin_w = cell_w // 4
    inner_h = cell_h - 2 * margin_h
    inner_w = cell_w - 2 * margin_w
    region = image[:grid * cell_h, :grid * cell_w]
    cells = region.reshape(grid, cell_h, grid, cell_w).permute(0, 2, 1, 3)
    inner = cells[:, :, margin_h:margin_h + inner_h,
                  margin_w:margin_w + inner_w]
    flat = inner.reshape(grid * grid, inner_h * inner_w)
    valid = torch.isfinite(flat) & (flat > 1e-7)
    counts = valid.sum(dim=1)
    invalid_frac = 1.0 - counts.to(torch.float32) / (inner_h * inner_w)
    svals = torch.sort(torch.where(valid, flat, float("inf")), dim=1).values
    i1 = torch.clamp(torch.div(counts - 1, 2, rounding_mode="floor"), min=0)
    i2 = torch.div(counts, 2, rounding_mode="floor")
    v1 = torch.gather(svals, 1, i1[:, None])[:, 0]
    v2 = torch.gather(svals, 1, i2[:, None])[:, 0]
    cell_median = torch.where(counts > 0, (v1 + v2) * 0.5, 0.0)

    gflat = image.reshape(-1)
    gvalid = torch.isfinite(gflat) & (gflat > 0.0)
    gcnt = gvalid.sum()
    gmed = select_half(torch.where(gvalid, gflat, float("inf")), gcnt)
    gdev = torch.where(gvalid, torch.abs(gflat - gmed), float("inf"))
    gmad = select_half(gdev, gcnt)
    return torch.cat([cell_median, invalid_frac, counts.to(torch.float32),
                      torch.stack([gmed, gmad])])


def _poly_basis(ny: np.ndarray, nx: np.ndarray, degree: int) -> np.ndarray:
    """[n, terms] with the reference's term ordering
    (background.rs:218-228: total degree ascending, y-power descending)."""
    cols = []
    for total in range(degree + 1):
        for y_pow in range(total, -1, -1):
            x_pow = total - y_pow
            cols.append((ny ** y_pow) * (nx ** x_pow))
    return np.stack(cols, axis=1)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y by square and multiply, the products of XLA's integer_pow."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _evaluate_model(coeffs: np.ndarray, rows: int, cols: int, degree: int,
                    device: torch.device) -> torch.Tensor:
    """The polynomial at every pixel, f32 on ``device``: normalized
    coordinates arange/n − 0.5 in f32, terms accumulated in the
    reference's order (background.py:125-134)."""
    c = torch.tensor(coeffs, dtype=torch.float32).to(device)
    ny = (torch.arange(rows, dtype=torch.float32, device=device) / rows
          - 0.5)[:, None]
    nx = (torch.arange(cols, dtype=torch.float32, device=device) / cols
          - 0.5)[None, :]
    out = torch.zeros((rows, cols), dtype=torch.float32, device=device)
    idx = 0
    for total in range(degree + 1):
        for y_pow in range(total, -1, -1):
            x_pow = total - y_pow
            out = out + c[idx] * _integer_pow(ny, y_pow) * \
                _integer_pow(nx, x_pow)
            idx += 1
    return out


def _apply_subtract(image, model, model_median):
    return image - model + model_median


def _apply_divide(image, model, model_median):
    safe = torch.abs(model) > 1e-10
    return torch.where(safe, image / torch.where(safe, model, 1.0)
                       * model_median, image)


def _finish(image: torch.Tensor, model: torch.Tensor,
            divide: bool) -> torch.Tensor:
    """The model median (one rank, over the finite positive model values)
    and the correction."""
    mflat = model.reshape(-1)
    mvalid = torch.isfinite(mflat) & (mflat > 0.0)
    model_median = select_half(torch.where(mvalid, mflat, float("inf")),
                               mvalid.sum())
    if divide:
        return _apply_divide(image, model, model_median)
    return _apply_subtract(image, model, model_median)


def _host_median(vals) -> float:
    v = np.sort(np.asarray(vals, np.float32))
    n = len(v)
    mid = n // 2
    if n == 0:
        return 0.0
    return float(v[mid]) if n % 2 else (float(v[mid - 1]) +
                                        float(v[mid])) / 2.0


def extract_background(image, config: BackgroundConfig = BackgroundConfig(),
                       progress: Optional[ProgressHandle] = None
                       ) -> BackgroundResult:
    """Fit and remove the background of ``image`` on its device (a
    tensor's own, else ``cuda_device()``)."""
    img = as_f32(image)
    rows, cols = img.shape
    grid = min(max(config.grid_size, 3), 32)
    degree = min(max(config.poly_degree, 1), 5)
    cell_h = rows // grid
    cell_w = cols // grid
    if cell_h < 4 or cell_w < 4:
        raise InvalidInput(f"Image too small for grid_size={grid}")

    if progress is not None:
        progress.tick_with_stage("sampling background")
    packed = _cell_medians(img, grid, cell_h, cell_w).cpu().numpy()
    nc = grid * grid
    cell_med = packed[:nc].astype(np.float64)
    invalid_frac = packed[nc:2 * nc]
    counts = packed[2 * nc:3 * nc].astype(np.int64)
    gmed = float(packed[3 * nc])
    sigma = float(packed[3 * nc + 1]) * MAD_TO_SIGMA

    margin_h, margin_w = cell_h // 4, cell_w // 4
    inner_h = cell_h - 2 * margin_h
    inner_w = cell_w - 2 * margin_w

    lo = gmed - config.sigma_clip * sigma
    hi = gmed + config.sigma_clip * sigma
    samples: List[Tuple[float, float, float]] = []
    for gy in range(grid):
        for gx in range(grid):
            i = gy * grid + gx
            if counts[i] == 0 or invalid_frac[i] > 0.3:
                continue
            v = cell_med[i]
            if lo <= v <= hi:
                cy = gy * cell_h + margin_h + inner_h // 2
                cx = gx * cell_w + margin_w + inner_w // 2
                samples.append((float(cy), float(cx), float(v)))

    # iterative retention on sample medians (background.rs:192-209)
    for _ in range(1, config.iterations):
        if len(samples) < min_samples_for_degree(degree):
            break
        vals = [s[2] for s in samples]
        med = _host_median(vals)
        mad = _host_median([abs(v - med) for v in vals])
        sig = mad * MAD_TO_SIGMA
        lo2, hi2 = med - config.sigma_clip * sig, med + config.sigma_clip * sig
        samples = [s for s in samples if lo2 <= s[2] <= hi2]

    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("fitting polynomial surface")
    if len(samples) < min_samples_for_degree(degree):
        raise InvalidInput(
            f"Not enough background samples ({len(samples)}) for polynomial "
            f"degree {degree}")

    s = np.asarray(samples, np.float64)
    ny = s[:, 0] / rows - 0.5
    nx = s[:, 1] / cols - 0.5
    basis = _poly_basis(ny, nx, degree)
    ata = basis.T @ basis + 1e-8 * np.eye(basis.shape[1])
    coeffs = np.linalg.solve(ata, basis.T @ s[:, 2])

    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("generating model")
    model = _evaluate_model(coeffs, rows, cols, degree, img.device)

    if progress is not None:
        progress.tick_with_stage("applying correction")
    corrected = _finish(img, model, config.mode == "divide")

    pred = basis @ coeffs
    rms = float(np.sqrt(np.mean((s[:, 2] - pred) ** 2)))
    return BackgroundResult(model=model, corrected=corrected,
                            sample_count=len(samples), rms_residual=rms)
