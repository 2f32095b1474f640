"""Pipelined ingest: host decode overlapping the copies to the device and
device compute (counterpart of astroburst_tpu/io/prefetch.py).

``DeviceLoader`` puts one decoded frame on a device. On a CUDA device
the FITS decode writes straight into a pinned host buffer (one pass,
no second copy), the host-to-device copy is issued ``non_blocking`` on
a side stream, and an event recorded after it makes the consumer
stream wait before any later work there. The loading thread keeps the
pinned buffer until the copy has finished (it waits on that event),
then drops it, and the caching host allocator hands the block to the
next frame. On the CPU nothing is pinned.

``load_cube`` puts a whole FITS cube on a device the same way, a chunk
of frames at a time through two pinned buffers, so the decode of one
chunk overlaps the copy of the last.

``prefetch_images`` runs loads on a bounded thread pool ``depth``
ahead of the consumer::

    for img in prefetch_images(paths, depth=2, device=dev):
        accumulate(img.image)   # device work overlaps the next decode
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from astroburst_tpu_torch.io.dispatcher import resolve_single_image
from astroburst_tpu_torch.errors import FitsError
from astroburst_tpu_torch.io.fits_reader import (Alloc, _Mapped,
                                                 decode_pixels, extract_cube,
                                                 extract_image, find_cube_hdu)
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import device_or_cuda

# loader(path, alloc) → an object whose ``image`` is the f32 ndarray
# that alloc returned (or a fresh one when alloc is None)
Loader = Callable[[str, Optional[Alloc]], object]


def _default_load(path: str, alloc: Optional[Alloc] = None):
    return extract_image(resolve_single_image(path), alloc)


class DeviceLoader:
    """Load a frame with ``loader`` and replace its ``image`` by an f32
    tensor on ``device``. Made on the consumer's thread: its current
    stream is the one that waits for each copy. Safe to call from
    several threads at once."""

    def __init__(self, device: torch.device,
                 loader: Optional[Loader] = None):
        self.device = torch.device(device)
        self.loader = loader or _default_load
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._consumer = torch.cuda.current_stream(self.device)
            self._side = torch.cuda.Stream(self.device)

    def __call__(self, path: str):
        if not self._cuda:
            img = self.loader(path, None)
            with trace.span("io.upload"):
                img.image = torch.from_numpy(np.ascontiguousarray(
                    img.image, np.float32)).to(self.device)
            return img
        pinned: List[torch.Tensor] = []

        def alloc(shape):
            buf = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            pinned.append(buf)
            return buf.numpy()

        img = self.loader(path, alloc)
        if len(pinned) != 1 or img.image.ctypes.data != pinned[0].data_ptr():
            raise ValueError(f"loader did not decode {path} into the one "
                             f"buffer alloc gave it")
        host = pinned[0]
        with trace.span("io.upload"):
            with torch.cuda.stream(self._side):
                dev = torch.empty(host.shape, dtype=torch.float32,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._side)
            self._consumer.wait_event(copied)
            dev.record_stream(self._consumer)
            copied.synchronize()   # the pinned buffer outlives the copy
        img.image = dev
        return img


CUBE_CHUNK_BYTES = 64 << 20   # one pinned staging buffer


def load_cube(path: str, device: torch.device):
    """(header, [C, H, W] f32 tensor on ``device``) of the first
    NAXIS=3 HDU of a FITS file (``io.fits_reader.extract_cube``). On a
    CUDA device the frames are decoded a chunk at a time into one of
    two pinned buffers and copied from there on a side stream; the
    consumer stream waits for the last copy. Span ``cube.load``, counter
    ``cube.load_bytes`` (the f32 bytes put on the device)."""
    device = torch.device(device)
    with trace.span("cube.load"):
        header, cube = _load_cube(path, device)
        trace.count("cube.load_bytes", cube.numel() * cube.element_size())
    return header, cube


def _load_cube(path: str, device: torch.device):
    if device.type != "cuda":
        fc = extract_cube(path)
        return fc.header, torch.from_numpy(fc.cube).to(device)
    with _Mapped(path) as buf:
        hdu = find_cube_hdu(buf)
        depth, fb = hdu.naxis3, hdu.frame_bytes
        if hdu.data_start + depth * fb > len(buf):
            raise FitsError("Cube data exceeds file size")
        frame = (hdu.naxis2, hdu.naxis1)
        chunk = max(1, min(depth, CUBE_CHUNK_BYTES // max(fb, 1)))
        out = torch.empty((depth, *frame), dtype=torch.float32,
                          device=device)
        consumer = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(consumer)   # ``out`` was allocated there
        stage = [torch.empty((chunk, *frame), dtype=torch.float32,
                             pin_memory=True) for _ in range(2)]
        done = [None, None]
        view = memoryview(buf)
        for i, z0 in enumerate(range(0, depth, chunk)):
            k = min(chunk, depth - z0)
            host = stage[i % 2][:k]
            if done[i % 2] is not None:
                done[i % 2].synchronize()   # its last copy has finished
            start = hdu.data_start + z0 * fb
            decode_pixels(view[start:start + k * fb], hdu.bitpix,
                          hdu.bscale, hdu.bzero, host.numpy())
            with torch.cuda.stream(side):
                out[z0:z0 + k].copy_(host, non_blocking=True)
                done[i % 2] = torch.cuda.Event()
                done[i % 2].record(side)
        consumer.wait_stream(side)
        for ev in done:
            if ev is not None:
                ev.synchronize()   # the staging buffers outlive the copies
        del view
    return hdu.header, out


def prefetch_images(paths: Sequence[str], depth: int = 2,
                    loader: Optional[Loader] = None,
                    device: Optional[torch.device] = None) -> Iterator:
    """Yield loaded images in order, their ``image`` an f32 tensor on
    ``device`` (default ``cuda_device()``), loading up to ``depth``
    ahead."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    load = DeviceLoader(device_or_cuda(device), loader)
    with cf.ThreadPoolExecutor(max_workers=depth) as pool:
        pending: List[cf.Future] = []
        it = iter(paths)
        try:
            for _ in range(depth):
                pending.append(pool.submit(load, next(it)))
        except StopIteration:
            pass
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(pool.submit(load, next(it)))
            except StopIteration:
                pass
            yield fut.result()


class PrefetchingStackLoader:
    """Decode N frames into an [N, H, W] stack on a device with host
    decode, copies to the device and any per-frame device preprocessing
    pipelined. Frames are cropped to the common minimum dims the way
    the stacker does (core/stacking/combine.rs:94-113)."""

    def __init__(self, depth: int = 2,
                 preprocess: Optional[Callable] = None,
                 device: Optional[torch.device] = None):
        self.depth = depth
        self.preprocess = preprocess
        self.device = device

    def load_stack(self, paths: Sequence[str]):
        frames = []
        headers = []
        for img in prefetch_images(paths, depth=self.depth,
                                   device=self.device):
            px = img.image
            if self.preprocess is not None:
                px = self.preprocess(px)
            frames.append(px)
            headers.append(getattr(img, "header", None))
        if not frames:
            raise ValueError("no input frames")
        min_r = min(int(f.shape[0]) for f in frames)
        min_c = min(int(f.shape[1]) for f in frames)
        stack = torch.stack([f[:min_r, :min_c] for f in frames])
        return stack, headers
