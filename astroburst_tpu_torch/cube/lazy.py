"""Lazy mmap IFU cube (counterpart of astroburst_tpu/cube/lazy.py, its
geometry and host code copied).

Reference: src-tauri/src/core/cube/lazy.rs — random-advise mmap,
CubeGeometry offsets, per-frame decode on demand, LRU frame cache
(64 frames), batch streaming (32); powers the "2 GB cube in 300 ms"
open. The host never materializes the full cube; frames decode from
the memory map only when touched. ``collapse_mean`` accumulates on the
host in f64 over f32 batch sums, as the JAX package does;
``collapse_median`` samples at most 256 frames and takes the port's
``cube.eager.collapse_median`` on a device.
"""

from __future__ import annotations

import mmap as _mmap
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from astroburst_tpu_torch.cube.eager import collapse_median
from astroburst_tpu_torch.errors import FitsError
from astroburst_tpu_torch.io.fits_reader import (_BITPIX_DTYPES,
                                                 decode_pixels,
                                                 find_cube_hdu)
from astroburst_tpu_torch.runtime.device import device_or_cuda

DEFAULT_CACHE_SIZE = 64
BATCH_SIZE = 32


@dataclass
class CubeGeometry:
    naxis1: int
    naxis2: int
    naxis3: int
    bitpix: int
    bytes_per_pixel: int
    bzero: float
    bscale: float
    data_offset: int
    frame_bytes: int


class LazyCube:
    """Frame-on-demand FITS cube over a read-only memory map."""

    def __init__(self, path: str, cache_frames: int = DEFAULT_CACHE_SIZE):
        self.path = path
        self._f = open(path, "rb")
        self._mm = _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)
        if hasattr(_mmap, "MADV_RANDOM"):
            try:
                self._mm.madvise(_mmap.MADV_RANDOM)
            except OSError:
                pass
        try:
            hdu = find_cube_hdu(self._mm)
        except FitsError:
            self.close()
            raise
        self.header = hdu.header
        self.geometry = CubeGeometry(
            naxis1=hdu.naxis1, naxis2=hdu.naxis2, naxis3=hdu.naxis3,
            bitpix=hdu.bitpix, bytes_per_pixel=abs(hdu.bitpix) // 8,
            bzero=hdu.bzero, bscale=hdu.bscale, data_offset=hdu.data_start,
            frame_bytes=hdu.frame_bytes)
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_max = cache_frames
        self._lock = threading.Lock()

    # -- frame access -----------------------------------------------------------

    def get_frame(self, idx: int) -> np.ndarray:
        g = self.geometry
        if not 0 <= idx < g.naxis3:
            raise FitsError(f"Frame index {idx} out of range 0..{g.naxis3}")
        with self._lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
        start = g.data_offset + idx * g.frame_bytes
        frame = decode_pixels(self._mm[start:start + g.frame_bytes],
                              g.bitpix, g.bscale, g.bzero).reshape(
                                  g.naxis2, g.naxis1)
        with self._lock:
            if len(self._cache) >= self._cache_max:
                self._cache.popitem(last=False)
            self._cache[idx] = frame
        return frame

    def iter_batches(self, batch_size: int = BATCH_SIZE, step: int = 1):
        """Yield (start_idx, [B, H, W] np.f32) streaming batches."""
        g = self.geometry
        indices = list(range(0, g.naxis3, max(step, 1)))
        for i in range(0, len(indices), batch_size):
            chunk = indices[i:i + batch_size]
            frames = np.stack([self.get_frame(z) for z in chunk])
            yield chunk[0], frames

    def spectrum(self, y: int, x: int) -> np.ndarray:
        """Per-pixel spectrum via strided single-pixel reads."""
        g = self.geometry
        if not (0 <= y < g.naxis2 and 0 <= x < g.naxis1):
            raise FitsError("Spectrum coordinates out of range")
        dt = _BITPIX_DTYPES[g.bitpix]
        pix_off = (y * g.naxis1 + x) * g.bytes_per_pixel
        out = np.empty(g.naxis3, np.float32)
        for z in range(g.naxis3):
            start = g.data_offset + z * g.frame_bytes + pix_off
            raw = self._mm[start:start + g.bytes_per_pixel]
            v = np.frombuffer(raw, dtype=dt)[0]
            out[z] = np.float32(float(v) * g.bscale + g.bzero)
        return out

    # -- streaming collapses ------------------------------------------------------

    def collapse_mean(self) -> np.ndarray:
        """Host f64 accumulation of f32 batch sums (the JAX package's
        own precision)."""
        g = self.geometry
        acc = np.zeros((g.naxis2, g.naxis1), np.float64)
        cnt = np.zeros((g.naxis2, g.naxis1), np.int64)
        for _start, batch in self.iter_batches():
            finite = np.isfinite(batch)
            acc += np.where(finite, batch, 0.0).sum(axis=0)
            cnt += finite.sum(axis=0)
        return np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0).astype(
            np.float32)

    def collapse_median(self, max_frames: int = 256,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
        """Median collapse on ``device`` (default ``cuda_device()``);
        cubes deeper than max_frames are sampled evenly (the reference's
        batch-bounded path)."""
        device = device_or_cuda(device)
        g = self.geometry
        step = max(1, -(-g.naxis3 // max_frames))
        frames = np.stack([self.get_frame(z)
                           for z in range(0, g.naxis3, step)])
        return collapse_median(torch.from_numpy(frames).to(device))

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def close(self) -> None:
        try:
            self._mm.close()
        except Exception:
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
