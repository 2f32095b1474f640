"""The plain reference of the benchmark: plain PyTorch and NumPy.

Frozen copies of the plain algorithms that the port's kernels are held
to (phase correlation, Catmull-Rom shift, per-pixel sigma clip, robust
statistics, auto-STF, histogram, the exact drizzle), and the
benchmark's own FITS reader and writer and PNG decoder. Nothing here
imports ``jax``, the JAX package or the port: the reference takes the
benchmark's inputs and works everything out again.

Every entry point takes a ``precision``: ``"f32"`` is the reference;
``"bf16"`` is the control, the same algorithms with the inputs and the
output of every stage rounded to bfloat16 (the FFTs, which have no
bfloat16 form, take the rounded values in float32).
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16")


def rounder(precision: str):
    """The rounding applied at each stage boundary for ``precision``."""
    if precision == "f32":
        return lambda t: t
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32) \
            if t.is_floating_point() else t
    raise ValueError(f"precision {precision!r}, expected one of "
                     f"{PRECISIONS}")
