"""Nearest-neighbour downsample of the preview (the part of
astroburst_tpu/ops/ipc.py that the ``stack`` command runs; reference:
src-tauri/src/infra/ipc.rs:105-147). The rest of that module (the
16-byte pixel header) comes with the STF preview chain.
"""

from __future__ import annotations

import torch


def _index_map(src: int, dst: int, device) -> torch.Tensor:
    """floor(d · src/dst) for d < dst, at most src - 1. The product is
    taken in f32 on a tensor, as the JAX package takes it (an int32
    arange times a weakly typed Python float): in f64 the map picks
    another source row at one of 4096 rows of a 5655-row plane."""
    d = torch.arange(dst, dtype=torch.int32, device=device)
    return torch.clamp((d * (src / dst)).to(torch.int32), max=src - 1)


def nearest_downsample(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """Nearest-neighbour downsample of [H, W] to fit max_dim: dst dims
    are round(src · max_dim / max(h, w)), source index floor(d · src /
    dst) (ipc.rs:105-147). Planes that fit are returned as they are."""
    h, w = x.shape
    if h <= max_dim and w <= max_dim:
        return x
    scale = max_dim / max(h, w)
    dst_h = max(int(round(h * scale)), 1)
    dst_w = max(int(round(w * scale)), 1)
    rows = _index_map(h, dst_h, x.device)
    cols = _index_map(w, dst_w, x.device)
    return x.index_select(0, rows).index_select(1, cols)
