"""Shared command plumbing: cached loaders, input resolution
(counterpart of astroburst_tpu/api/common.py).

Reference: src-tauri/src/cmd/common.rs — cached loaders
(load_cached/load_cached_full), ZIP/ASDF-transparent resolution, JWST
calibration-reference ASDF rejection (common.rs:30-56), preview caps.
Every loader takes the device its tensors go to (default
``cuda_device()``). Frames reach a CUDA device through
``io/prefetch.DeviceLoader``, which decodes into pinned memory: an ASDF
plane is copied into the buffer it is given, so every loader takes
ASDF frames too.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from astroburst_tpu_torch.errors import CacheMiss, InvalidInput
from astroburst_tpu_torch.io import (FitsRgb, extract_image,
                                     resolve_single_image, try_extract_rgb)
from astroburst_tpu_torch.io.asdf import extract_image_from_asdf
from astroburst_tpu_torch.io.dispatcher import is_asdf_path
from astroburst_tpu_torch.io.fits_reader import Alloc
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.io.prefetch import DeviceLoader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE, CacheEntry
from astroburst_tpu_torch.runtime.device import device_or_cuda

MAX_PREVIEW_DIM = 4096       # common.rs:16
MAX_RAW_PREVIEW_DIM = 2048   # io/mod.rs:178

# JWST calibration-reference ASDF files are not images (common.rs:30-56)
CALIB_PATTERNS = (
    "distortion", "filteroffset", "sirskernel", "photom",
    "flat", "dark", "bias", "readnoise", "gain", "linearity",
    "saturation", "superbias", "ipc", "area", "specwcs",
    "regions", "wavelengthrange", "trappars", "mask",
)


def reject_calibration_asdf(path: str) -> None:
    if not path.lower().endswith(".asdf"):
        return
    name = os.path.basename(path).lower()
    for pat in CALIB_PATTERNS:
        if pat in name:
            raise InvalidInput(
                f"'{os.path.basename(path)}' looks like a JWST calibration "
                f"reference file ({pat}), not an image")


@dataclass
class ResolvedImage:
    image: np.ndarray
    header: HduHeader


def extract_image_resolved(path: str,
                           alloc: Optional[Alloc] = None) -> ResolvedImage:
    """ZIP/dir/ASDF-transparent single image extraction
    (common.rs:75-90), into ``alloc(shape)`` when it is given: a FITS
    plane is decoded into it, an ASDF plane copied into it."""
    resolved = resolve_single_image(path)
    reject_calibration_asdf(resolved)
    if is_asdf_path(resolved):
        img = extract_image_from_asdf(resolved)
        plane = img.image
        if alloc is not None:
            plane = alloc(plane.shape)
            np.copyto(plane, img.image)
        return ResolvedImage(plane, img.header)
    fi = extract_image(resolved, alloc)
    return ResolvedImage(fi.image, fi.header)


def try_extract_rgb_resolved(path: str) -> Optional[FitsRgb]:
    resolved = resolve_single_image(path)
    if is_asdf_path(resolved):
        return None
    return try_extract_rgb(resolved)


def _attach_stats(key: str, entry: CacheEntry) -> CacheEntry:
    """Fill entry.stats through the cache's lock-protected upgrade path
    so concurrent callers agree on one ImageStats. If the entry was
    evicted meanwhile it is no longer shared and a direct assignment is
    safe."""
    if entry.stats is None:
        stats = compute_image_stats(entry.image)
        GLOBAL_IMAGE_CACHE.upgrade_stats(key, stats)
        if entry.stats is None:
            entry.stats = stats
    return entry


def load_cached(path: str, device: Optional[torch.device] = None
                ) -> CacheEntry:
    """Cache lookup keyed by path, for ``device``; decodes and computes
    stats on a miss (common.rs:124-150)."""
    device = device_or_cuda(device)
    entry = GLOBAL_IMAGE_CACHE.get(path, device)
    if entry is not None and entry.stats is not None:
        return entry
    if entry is None:
        resolved = DeviceLoader(device, extract_image_resolved)(path)
        entry = GLOBAL_IMAGE_CACHE.insert(path, resolved.image,
                                          header=resolved.header)
    return _attach_stats(path, entry)


def load_cached_many(paths, depth: int = 2,
                     device: Optional[torch.device] = None
                     ) -> List[CacheEntry]:
    """load_cached over a path list with the host decode and the copy
    to the device (io/prefetch.py's DeviceLoader) pipelined ahead of
    the stats: uncached files load on a bounded thread pool while
    earlier entries' stats run. Returns the entries in input order;
    cache semantics as load_cached (past the cache's entry cap, early
    entries are evicted while the returned list still holds them)."""
    device = device_or_cuda(device)
    paths = list(paths)
    cached = {p: GLOBAL_IMAGE_CACHE.get(p, device) for p in paths}
    to_load = [p for p in paths if cached[p] is None
               or cached[p].stats is None]
    results = {}
    if to_load:
        load = DeviceLoader(device, extract_image_resolved)
        with cf.ThreadPoolExecutor(max_workers=max(depth, 1)) as pool:
            futs = {p: pool.submit(load, p) for p in dict.fromkeys(to_load)}
            for p in to_load:
                resolved = futs[p].result()
                entry = GLOBAL_IMAGE_CACHE.insert(p, resolved.image,
                                                  header=resolved.header)
                results[p] = _attach_stats(p, entry)
    return [results.get(p) or cached[p] for p in paths]


def load_cached_full(path: str, device: Optional[torch.device] = None
                     ) -> CacheEntry:
    """Like load_cached but guarantees a header is attached."""
    device = device_or_cuda(device)
    entry = GLOBAL_IMAGE_CACHE.get(path, device)
    if entry is not None and entry.stats is not None \
            and entry.header is not None:
        return entry
    resolved = DeviceLoader(device, extract_image_resolved)(path)
    entry = GLOBAL_IMAGE_CACHE.insert(path, resolved.image,
                                      header=resolved.header)
    return _attach_stats(path, entry)


def load_many_from_cache_or_disk(keys_or_paths, depth: int = 2,
                                 device: Optional[torch.device] = None
                                 ) -> List[CacheEntry]:
    """load_from_cache_or_disk over a list, disk misses decoded on a
    bounded thread pool (see load_cached_many). Order preserved."""
    device = device_or_cuda(device)
    out = {}
    disk = []
    for p in keys_or_paths:
        if p in out:
            continue
        entry = GLOBAL_IMAGE_CACHE.get(p, device)
        if entry is not None:
            out[p] = _attach_stats(p, entry)
        elif p.startswith("__"):
            raise CacheMiss(f"cache key not found: {p}")
        else:
            disk.append(p)
    if disk:
        for p, entry in zip(disk, load_cached_many(disk, depth, device)):
            out[p] = entry
    return [out[p] for p in keys_or_paths]


def load_from_cache_or_disk(key_or_path: str,
                            device: Optional[torch.device] = None
                            ) -> CacheEntry:
    """Accept a pinned cache key or a filesystem path (common.rs:124-150)."""
    device = device_or_cuda(device)
    entry = GLOBAL_IMAGE_CACHE.get(key_or_path, device)
    if entry is not None:
        return _attach_stats(key_or_path, entry)
    if key_or_path.startswith("__"):
        raise CacheMiss(f"cache key not found: {key_or_path}")
    return load_cached(key_or_path, device)


class Timer:
    def __init__(self):
        self.t0 = time.monotonic()

    def elapsed_ms(self) -> int:
        return int((time.monotonic() - self.t0) * 1000)


def png_path_for(path: str, output_dir: str, suffix: str = "") -> str:
    stem = os.path.splitext(os.path.basename(path))[0] or "output"
    if suffix:
        stem = f"{stem}_{suffix}"
    return os.path.join(output_dir, f"{stem}.png")
