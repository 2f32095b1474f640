"""Inputs carried from the JAX package to the port.

The system has no learned weights: what crosses from JAX to torch is
the data (frame stacks), the configuration and the alignment chain's
state; the port's records (``dtypes.StackConfig``, ``DrizzleConfig``)
have the JAX package's fields and defaults. Tests and chip_smoke.py
feed both packages through ``stack_from_numpy``; a JAX ``RefStars``
crosses through ``ref_stars_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch


def stack_from_numpy(arr, device, true_shape: tuple | None = None
                     ) -> torch.Tensor:
    """A contiguous f32 [N, h, w] tensor on ``device``.

    ``arr`` is a plain [N, H, W] array (numpy, or anything
    ``np.asarray`` takes, such as a JAX array), or a stack in the JAX
    ingest layout — padded by ``onepass_kernel.pad_stack_aligned`` —
    together with its ``true_shape=(h, w)``, whose pad is cut off here.
    """
    a = np.asarray(arr)
    if a.ndim != 3:
        raise ValueError(f"expected an [N, H, W] stack, got shape {a.shape}")
    if true_shape is not None:
        h, w = true_shape
        if h > a.shape[1] or w > a.shape[2]:
            raise ValueError(f"true_shape {true_shape} exceeds the stack "
                             f"{a.shape}")
        a = a[:, :h, :w]
    a = np.ascontiguousarray(a, dtype=np.float32)
    return torch.from_numpy(a).to(device)


def ref_stars_from_numpy(xs, ys, n, ratios_t, verts_t, shape, max_peaks,
                         device):
    """The port's ``fused_chain.RefStars`` on ``device`` from a JAX
    ``RefStars`` given as numpy arrays: ``xs``, ``ys`` [60] (+inf in
    empty slots), ``n``, ``ratios_t`` [2, TP] and ``verts_t`` [3, TP],
    TP = 34816, the triangles sorted by their first ratio and padded
    with +inf rows to the Pallas vote's block multiple. The arrays are
    transposed to the port's [T, 2] / [T, 3] layout and the pad — the
    TP − C(60, 3) last rows — is dropped; the votes do not depend on the
    order of the rows, so the rest are the same triangles."""
    from astroburst_tpu_torch.alignment.fused_chain import N_TRI, RefStars
    ratios = np.ascontiguousarray(np.asarray(ratios_t, np.float32).T)
    verts = np.ascontiguousarray(np.asarray(verts_t, np.int32).T)
    if ratios.shape[1] != 2 or verts.shape[1] != 3 or \
            len(ratios) != len(verts) or len(ratios) < N_TRI:
        raise ValueError(f"expected ratios_t [2, TP] and verts_t [3, TP] "
                         f"with TP >= {N_TRI}, got {np.shape(ratios_t)} and "
                         f"{np.shape(verts_t)}")
    if not np.isinf(ratios[N_TRI:]).all():
        raise ValueError("the rows past C(60, 3) are not +inf pad")

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return RefStars(f32(xs), f32(ys),
                    torch.tensor(int(n), dtype=torch.int32, device=device),
                    torch.from_numpy(ratios[:N_TRI]).to(device),
                    torch.from_numpy(verts[:N_TRI]).to(device),
                    tuple(shape), int(max_peaks))
