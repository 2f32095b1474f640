"""K10: the per-tile sort of the star-detection background.

Counterpart of astroburst_tpu/analysis/tile_sort_kernel.py:
``sort_tiles_pallas``; the CUDA kernels are in ``csrc/tile_sort.cu``
(header note there: what bounds them and how they are laid out). A
NaN-padded [ty·step, tx·step] plane becomes (each tile's values sorted
ascending with the invalid ones — non-finite or ≤ PADDING_THRESHOLD —
mapped to +inf, [ty·tx, step²] f32; the valid count per tile, [ty·tx]
i32). The kernels take every step (the TPU kernel took powers of two
only and the JAX code sent the others to XLA's sort) and are bit-equal
to the plain version, the masked ``torch.sort`` of
star_detection.py:199-203.

Two routes: a radix sort over one thread-block cluster per tile
(``sort_tiles``, the plan from ``_tile_plan``), and, for a tile larger
than the largest cluster holds (step > 256, on no path), the chunked
bitonic sort with merges through a global scratch
(``sort_tiles_chunked``, its own launch count). ``sort_tiles`` launches
a kernel for a CUDA tensor and runs ``sort_tiles_plain`` for a CPU
tensor; it never falls back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.ops.masking import validity_mask
from astroburst_tpu_torch.runtime import kernels as K

KEYS_PER_THREAD = 16    # radix route: keys a thread holds
MIN_THREADS, MAX_THREADS = 256, 512   # radix route: threads a block
MAX_CLUSTER = 8         # blocks a cluster (the largest portable size)
MAX_CHUNK = 16384       # chunked route: keys sorted in shared memory at once


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


def _tile_plan(n: int):
    """(blocks per cluster, threads per block) of the radix route for a
    tile of ``n`` keys: the smallest cluster of 1, 2, 4 or 8 blocks of at
    most MAX_THREADS · KEYS_PER_THREAD keys that holds it, and the
    fewest threads (a power of two, at least MIN_THREADS) that hold its
    share; None past MAX_CLUSTER such blocks (the chunked route)."""
    per_block = MAX_THREADS * KEYS_PER_THREAD
    if n > MAX_CLUSTER * per_block:
        return None
    csize = 1
    while csize * per_block < n:
        csize *= 2
    need = -(-max(n, 1) // (csize * KEYS_PER_THREAD))
    return csize, max(MIN_THREADS, 1 << (need - 1).bit_length())


def _chunks(n: int):
    """(chunk, n_chunks) of the chunked route: powers of two, one chunk
    of next_pow2(n) keys while that fits shared memory, else
    MAX_CHUNK-key chunks (always the latter past the radix route)."""
    if n <= MAX_CHUNK:
        return 1 << max(n - 1, 1).bit_length(), 1
    return MAX_CHUNK, 1 << (-(-n // MAX_CHUNK) - 1).bit_length()


def _outputs(ty: int, tx: int, n: int, dev):
    return (torch.empty((ty * tx, n), dtype=torch.float32, device=dev),
            torch.empty(ty * tx, dtype=torch.int32, device=dev))


def sort_tiles_chunked(padded: torch.Tensor, step: int):
    """The chunked route's launch, for a tile past the radix route's
    largest cluster (``sort_tiles`` sends it here)."""
    ty, tx = _grid(padded, step)
    n = step * step
    chunk, n_chunks = _chunks(n)
    scratch = torch.empty((ty * tx, 2, chunk * n_chunks), dtype=torch.int32,
                          device=padded.device)
    out, counts = _outputs(ty, tx, n, padded.device)
    K.launch("abt_tile_sort_chunked", padded.data_ptr(), ty, tx, step,
             chunk, n_chunks, scratch.data_ptr(), out.data_ptr(),
             counts.data_ptr(), K.stream_handle(padded))
    sort_tiles_chunked.launches += 1
    return out, counts


def sort_tiles(padded: torch.Tensor, step: int):
    """Sorted tiles and valid counts of a [ty·step, tx·step] plane."""
    if not K.use_kernel(padded, "sort_tiles"):
        return sort_tiles_plain(padded, step)
    K.require_cuda(padded, "padded", 2)
    ty, tx = _grid(padded, step)
    n = step * step
    plan = _tile_plan(n)
    if plan is None:
        return sort_tiles_chunked(padded, step)
    out, counts = _outputs(ty, tx, n, padded.device)
    K.launch("abt_tile_sort", padded.data_ptr(), ty, tx, step, *plan,
             out.data_ptr(), counts.data_ptr(), K.stream_handle(padded))
    sort_tiles.launches += 1
    return out, counts


sort_tiles.launches = 0
sort_tiles_chunked.launches = 0
