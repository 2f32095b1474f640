"""Bicubic resampling with WCS keyword rescaling (counterpart of
astroburst_tpu/imaging/resample.py; not ``ops/resample.py``, which is
the sub-pixel shift).

Reference: src-tauri/src/core/imaging/resample.rs — Catmull-Rom
resampling at sy = ty·scale + (scale−1)/2, plus CRPIX/CD(or CDELT)
updates (resample.rs:63-109).

The source coordinate depends separably on the output index, so the
resize is four weighted ``index_select``s per axis, summed in tap order
j = 0..3 (rows first, then columns), with index and weight vectors made
on the host in f64 and the weights rounded to f32, as the JAX package
makes them. Every product and sum is its own f32 operation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.io.header import HduHeader


def _np_catmull_rom(t: np.ndarray) -> np.ndarray:
    a = np.abs(t)
    inner = a * a * (1.5 * a - 2.5) + 1.0
    outer = a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0
    return np.where(a <= 1.0, inner, np.where(a <= 2.0, outer, 0.0))


@lru_cache(maxsize=64)
def _axis_taps(n_src: int, n_tgt: int) -> Tuple[Tuple[np.ndarray, ...],
                                                Tuple[np.ndarray, ...]]:
    """4 (index, weight) vector pairs for one axis (host f64, weights
    rounded to f32)."""
    scale = n_src / n_tgt
    half_shift = (scale - 1.0) * 0.5
    s = np.arange(n_tgt) * scale + half_shift
    i0 = np.floor(s).astype(np.int64)
    f = s - i0
    idxs = []
    ws = []
    for j in range(4):
        idxs.append(np.clip(i0 + j - 1, 0, n_src - 1))
        ws.append(_np_catmull_rom(f - (j - 1)).astype(np.float32))
    return tuple(idxs), tuple(ws)


def _weighted_taps(image: torch.Tensor, n_tgt: int, axis: int
                   ) -> torch.Tensor:
    """Σ_j w_j · take(image, i_j, axis), j = 0..3 in order."""
    idxs, ws = _axis_taps(int(image.shape[axis]), n_tgt)
    out = None
    for i, w in zip(idxs, ws):
        w_t = torch.from_numpy(w).to(image.device)
        w_t = w_t[:, None] if axis == 0 else w_t[None, :]
        term = w_t * image.index_select(
            axis, torch.from_numpy(i).to(image.device))
        out = term if out is None else out + term
    return out


def resample_image(image: torch.Tensor, target_rows: int,
                   target_cols: int) -> torch.Tensor:
    """Bicubic resize of an f32 [H, W] tensor on its device
    (resample.rs:25-61); a plane of the target shape comes back as is."""
    if target_rows <= 0 or target_cols <= 0:
        raise InvalidInput("Target dimensions must be > 0")
    if tuple(image.shape) == (target_rows, target_cols):
        return image
    return _weighted_taps(_weighted_taps(image, target_rows, 0),
                          target_cols, 1)


def compute_wcs_updates(header: HduHeader, original_dims: Tuple[int, int],
                        target_dims: Tuple[int, int]
                        ) -> List[Tuple[str, float]]:
    """CRPIX/CD/CDELT rescale (resample.rs:63-109), host f64."""
    orig_rows, orig_cols = original_dims
    tgt_rows, tgt_cols = target_dims
    scale_x = orig_cols / tgt_cols
    scale_y = orig_rows / tgt_rows
    updates: List[Tuple[str, float]] = []
    crpix1 = header.get_f64("CRPIX1")
    if crpix1 is not None:
        updates.append(("CRPIX1", (crpix1 - 0.5) / scale_x + 0.5))
    crpix2 = header.get_f64("CRPIX2")
    if crpix2 is not None:
        updates.append(("CRPIX2", (crpix2 - 0.5) / scale_y + 0.5))
    cd1_1 = header.get_f64("CD1_1")
    if cd1_1 is not None:
        updates.append(("CD1_1", cd1_1 * scale_x))
        for key, sc in (("CD1_2", scale_y), ("CD2_1", scale_x),
                        ("CD2_2", scale_y)):
            v = header.get_f64(key)
            if v is not None:
                updates.append((key, v * sc))
    else:
        for key, sc in (("CDELT1", scale_x), ("CDELT2", scale_y)):
            v = header.get_f64(key)
            if v is not None:
                updates.append((key, v * sc))
    updates.append(("NAXIS1", float(tgt_cols)))
    updates.append(("NAXIS2", float(tgt_rows)))
    return updates


@dataclass
class ResampleResult:
    image: torch.Tensor
    header_updates: List[Tuple[str, float]]
    original_dims: Tuple[int, int]
    resampled_dims: Tuple[int, int]


def resample_with_wcs(image: torch.Tensor, header: HduHeader,
                      target_rows: int, target_cols: int) -> ResampleResult:
    dims = (int(image.shape[0]), int(image.shape[1]))
    return ResampleResult(
        image=resample_image(image, target_rows, target_cols),
        header_updates=compute_wcs_updates(header, dims,
                                           (target_rows, target_cols)),
        original_dims=dims,
        resampled_dims=(target_rows, target_cols))
