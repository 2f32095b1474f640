"""Inputs carried from the JAX package to the port.

The system has no learned weights: what crosses from JAX to torch is
the data (frame stacks) and the configuration; the port's records
(``dtypes.StackConfig``, ``DrizzleConfig``) have the JAX package's
fields and defaults. Tests and chip_smoke.py feed both packages
through ``stack_from_numpy``.
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
