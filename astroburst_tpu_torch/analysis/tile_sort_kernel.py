"""K10: the per-tile sort of the star-detection background.

Counterpart of astroburst_tpu/analysis/tile_sort_kernel.py:
``sort_tiles_pallas``; the CUDA kernel is ``csrc/tile_sort.cu`` (header
note there: what bounds it and how it is laid out). A NaN-padded
[ty·step, tx·step] plane becomes (each tile's values sorted ascending
with the invalid ones — non-finite or ≤ PADDING_THRESHOLD — mapped to
+inf, [ty·tx, step²] f32; the valid count per tile, [ty·tx] i32). The
kernel takes every step (the TPU kernel took powers of two only and the
JAX code sent the others to XLA's sort) and is bit-equal to the plain
version, the masked ``torch.sort`` of star_detection.py:199-203.

``sort_tiles`` launches the kernel for a CUDA tensor and runs
``sort_tiles_plain`` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.masking import validity_mask
from astroburst_tpu_torch.runtime import kernels as K

MAX_CHUNK = 16384  # keys sorted in shared memory at once (64 KiB)


def _grid(padded: torch.Tensor, step: int):
    """(ty, tx) tiles of a [ty·step, tx·step] plane; raises otherwise."""
    rows, cols = padded.shape
    if step < 1 or rows % step or cols % step:
        raise ValueError(f"step {step} must divide the plane {rows}x{cols}")
    return rows // step, cols // step


def sort_tiles_plain(padded: torch.Tensor, step: int):
    """(sorted tiles [ty·tx, step²] with +inf tails, valid counts
    [ty·tx] i32) by ``torch.sort``."""
    ty, tx = _grid(padded, step)
    tiles = padded.reshape(ty, step, tx, step).permute(0, 2, 1, 3).reshape(
        ty * tx, step * step)
    valid = validity_mask(tiles)
    counts = valid.sum(dim=1, dtype=torch.int32)
    return torch.sort(torch.where(valid, tiles, float("inf")),
                      dim=1).values, counts


def _chunks(n: int):
    """(chunk, n_chunks): powers of two, one chunk of next_pow2(n) keys
    while that fits shared memory, else MAX_CHUNK-key chunks."""
    if n <= MAX_CHUNK:
        return 1 << max(n - 1, 1).bit_length(), 1
    return MAX_CHUNK, 1 << (-(-n // MAX_CHUNK) - 1).bit_length()


def sort_tiles(padded: torch.Tensor, step: int):
    """Sorted tiles and valid counts of a [ty·step, tx·step] plane."""
    if not K.use_kernel(padded, "sort_tiles"):
        return sort_tiles_plain(padded, step)
    K.require_cuda(padded, "padded", 2)
    ty, tx = _grid(padded, step)
    n = step * step
    chunk, n_chunks = _chunks(n)
    dev = padded.device
    scratch = torch.empty((ty * tx, 2, chunk * n_chunks), dtype=torch.int32,
                          device=dev) if n_chunks > 1 else None
    out = torch.empty((ty * tx, n), dtype=torch.float32, device=dev)
    counts = torch.empty(ty * tx, dtype=torch.int32, device=dev)
    K.launch("abt_tile_sort", padded.data_ptr(), ty, tx, step, chunk,
             n_chunks, K.ptr(scratch), out.data_ptr(), counts.data_ptr(),
             K.stream_handle(padded))
    sort_tiles.launches += 1
    return out, counts


sort_tiles.launches = 0
