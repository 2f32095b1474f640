"""Global LRU image cache holding f32 planes on a device
(counterpart of astroburst_tpu/runtime/cache.py; reference:
src-tauri/src/infra/cache.rs).

Entries are f32 torch tensors, each on the one device it was inserted
for, with optional ImageStats and header attached. Composite
(``__composite*``), wizard (``__wizard_ch_*``) and star-mask keys are
pinned and never evicted (cache.rs:90-92). Eviction is
generation-counter LRU with caps on entries and bytes
(cache.rs:306-310). The stats/header upgrade paths are kept
(cache.rs:245-269).

This cache is the port's own: the JAX package's ``GLOBAL_IMAGE_CACHE``
is another object, and tests clear each one separately.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.constants import STAR_MASK_KEY, WIZARD_CACHE_PREFIX
from astroburst_tpu_torch.dtypes import ImageStats
from astroburst_tpu_torch.errors import CacheMiss
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.runtime.device import cuda_device

DEFAULT_MAX_ENTRIES = 32
DEFAULT_MAX_BYTES = 2 * 1024 * 1024 * 1024  # cache.rs:306-310


def is_pinned_key(key: str) -> bool:
    return key.startswith("__composite") or key.startswith(
        WIZARD_CACHE_PREFIX) or key == STAR_MASK_KEY


def canonical_device(device) -> torch.device:
    """``device`` with the current CUDA index filled in, so that
    ``cuda`` and ``cuda:0`` compare equal where device 0 is current."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass
class CacheEntry:
    image: torch.Tensor                   # f32 [H, W] on its device
    stats: Optional[ImageStats] = None
    header: Optional[HduHeader] = None
    generation: int = 0

    @property
    def nbytes(self) -> int:
        return self.image.numel() * 4


class ImageCache:
    """Thread-safe LRU of device tensors with pinned keys.

    Lookups may name the device the caller works on. An entry that
    lives on another device is then not handed back: ``get`` returns
    None, as for a key that is absent, and ``require`` raises
    CacheMiss. The entry stays where it is until an insert under the
    same key (the caller loading the file again for its device)
    replaces it, or the LRU evicts it.
    """

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self._lock = threading.RLock()
        self._entries: Dict[str, CacheEntry] = {}
        self._gen = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    # -- core ---------------------------------------------------------------

    def _touch(self, entry: CacheEntry) -> None:
        self._gen += 1
        entry.generation = self._gen

    def _evict_if_needed(self) -> None:
        def evictable():
            return [k for k in self._entries if not is_pinned_key(k)]

        while len(self._entries) > self.max_entries:
            victims = evictable()
            if not victims:
                break  # everything pinned: never loop forever (cache.rs:432)
            oldest = min(victims, key=lambda k: self._entries[k].generation)
            del self._entries[oldest]
        while sum(e.nbytes for e in self._entries.values()) > self.max_bytes:
            victims = evictable()
            if not victims:
                break
            oldest = min(victims, key=lambda k: self._entries[k].generation)
            del self._entries[oldest]

    def insert(self, key: str, image, stats: Optional[ImageStats] = None,
               header: Optional[HduHeader] = None,
               device: Optional[torch.device] = None) -> CacheEntry:
        """Insert ``image`` as f32 on ``device`` (default: a tensor's own
        device, else ``cuda_device()``)."""
        arr = _to_device_f32(image, device)
        with self._lock:
            entry = CacheEntry(arr, stats, header)
            self._touch(entry)
            self._entries[key] = entry
            self._evict_if_needed()
            return entry

    def get(self, key: str,
            device: Optional[torch.device] = None) -> Optional[CacheEntry]:
        """The entry under ``key``, or None when there is none or (with
        ``device`` given) it lives on another device."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or (device is not None and e.image.device !=
                             canonical_device(device)):
                return None
            self._touch(e)
            return e

    def require(self, key: str,
                device: Optional[torch.device] = None) -> CacheEntry:
        e = self.get(key, device)
        if e is None:
            raise CacheMiss(f"cache key not found: {key}")
        return e

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def remove(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def remove_prefix(self, prefix: str) -> int:
        with self._lock:
            victims = [k for k in self._entries if k.startswith(prefix)]
            for k in victims:
                del self._entries[k]
            return len(victims)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    # -- upgrade paths (cache.rs:245-269) ------------------------------------

    def upgrade_stats(self, key: str, stats: ImageStats) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.stats is None:
                e.stats = stats

    def upgrade_header(self, key: str, header: HduHeader) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.header is None:
                e.header = header

    def get_or_load(self, key: str,
                    loader: Callable[[], Tuple[object, Optional[ImageStats],
                                               Optional[HduHeader]]],
                    device: Optional[torch.device] = None) -> CacheEntry:
        """Return the cached entry or load and insert it (cache.rs:183)."""
        e = self.get(key, device)
        if e is not None:
            return e
        image, stats, header = loader()
        return self.insert(key, image, stats, header, device)


def _to_device_f32(image, device: Optional[torch.device]) -> torch.Tensor:
    if device is None:
        device = image.device if isinstance(image, torch.Tensor) else \
            cuda_device()
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    return image.to(device=device, dtype=torch.float32)


GLOBAL_IMAGE_CACHE = ImageCache()
