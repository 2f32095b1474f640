"""Pairwise alignment (counterpart of astroburst_tpu/alignment/pair.py;
reference: src-tauri/src/core/alignment/pair.rs and
src-tauri/src/core/stacking/align.rs:84-170).

``align_pair(AFFINE)`` takes the fused device chain
(alignment/fused_chain: one device program, one host fetch) for planes
on the card when the canvas is the reference's, as the JAX package
takes it on its TPU; ``ref_stars`` (``fused_chain.detect_ref_stars``)
then skips detecting a shared reference again. Elsewhere — planes on
the CPU, or another canvas — it runs the host chain of alignment/affine
(detect, vote and warp on the device, triangles, matching and RANSAC on
the host) and warps with ``warp_image``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from astroburst_tpu_torch.alignment import fused_chain
from astroburst_tpu_torch.alignment.affine import (align_channel_affine,
                                                   warp_image)
from astroburst_tpu_torch.alignment.phase_correlation import phase_correlate
from astroburst_tpu_torch.dtypes import AlignMethod
from astroburst_tpu_torch.ops.resample import shift_bicubic
from astroburst_tpu_torch.runtime.device import as_f32

log = logging.getLogger("astroburst_tpu_torch.align")


@dataclass
class AlignPairResult:
    aligned: torch.Tensor
    offset: tuple           # (dy, dx)
    confidence: float
    method_used: str
    matched_stars: int = 0
    inliers: int = 0
    residual_px: float = 0.0


def shift_image_subpixel(image, dy: float, dx: float) -> torch.Tensor:
    """Bicubic global shift (core/stacking/align.rs:36-57)."""
    img = as_f32(image)
    if abs(dy) < 1e-12 and abs(dx) < 1e-12:
        return img
    return shift_bicubic(img, dy, dx)


def estimate_offset(reference, target, method: AlignMethod):
    """(dy, dx, confidence) of ``target`` against ``reference``: the
    affine chain's translation (confidence 1 with inliers, else 0), or
    phase correlation."""
    if method == AlignMethod.AFFINE:
        r = align_channel_affine(reference, target)
        return (r.transform.ty, r.transform.tx,
                1.0 if r.inliers > 0 else 0.0)
    ref = as_f32(reference)
    pc = phase_correlate(ref, as_f32(target, ref.device))
    return pc.dy, pc.dx, pc.confidence


def align_pair(reference, target, method: AlignMethod, rows: int,
               cols: int, ref_stars=None) -> AlignPairResult:
    """Align ``target`` onto ``reference`` and resample it onto a
    rows × cols canvas (affine) or shift it (phase correlation)."""
    if method == AlignMethod.AFFINE:
        ref = as_f32(reference)
        if (fused_chain.takes_fused_chain(ref)
                and (rows, cols) == tuple(ref.shape)):
            # the fused chain warps onto the reference's canvas, so it
            # takes only that canvas; another goes to the host chain
            warped, result = fused_chain.align_and_warp(
                ref, target, ref_stars=ref_stars)
        else:
            result = align_channel_affine(ref, target)
            warped = warp_image(as_f32(target), result.transform,
                                rows, cols)
        return AlignPairResult(
            aligned=warped,
            offset=(result.transform.ty, result.transform.tx),
            confidence=1.0 if result.inliers > 0 else 0.0,
            method_used=result.method,
            matched_stars=result.matched_stars,
            inliers=result.inliers,
            residual_px=result.residual_px,
        )
    ref = as_f32(reference)
    tgt = as_f32(target, ref.device)
    pc = phase_correlate(ref, tgt)
    shifted = shift_image_subpixel(tgt, pc.dy, pc.dx)
    return AlignPairResult(
        aligned=shifted, offset=(pc.dy, pc.dx), confidence=pc.confidence,
        method_used="phase_correlation")


def align_pair_with_label(reference, target, method: AlignMethod, rows: int,
                          cols: int, label: str,
                          ref_stars=None) -> AlignPairResult:
    result = align_pair(reference, target, method, rows, cols,
                        ref_stars=ref_stars)
    log.info("%s alignment: %s, offset=(%.2f, %.2f), confidence=%.4f, "
             "inliers=%d", label, result.method_used, result.offset[0],
             result.offset[1], result.confidence, result.inliers)
    return result
