"""Progress events and cooperative cancellation.

Its own copy of astroburst_tpu/runtime/progress.py. Reference:
src-tauri/src/infra/progress.rs — atomic counters, a 50 ms
emit throttle, and a cancellation flag checked inside long loops. Here
the "frontend" is any callable sink; library users can subscribe per
event name.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from astroburst_tpu_torch.errors import Cancelled

EMIT_THROTTLE_S = 0.050  # progress.rs:7

_SINKS_LOCK = threading.Lock()
_SINKS: Dict[str, List[Callable[[dict], None]]] = {}
_GLOBAL_SINKS: List[Callable[[str, dict], None]] = []


def subscribe(event: str, sink: Callable[[dict], None]) -> None:
    with _SINKS_LOCK:
        _SINKS.setdefault(event, []).append(sink)


def subscribe_all(sink: Callable[[str, dict], None]) -> None:
    with _SINKS_LOCK:
        _GLOBAL_SINKS.append(sink)


def unsubscribe(event: str, sink: Callable[[dict], None]) -> None:
    with _SINKS_LOCK:
        if event in _SINKS and sink in _SINKS[event]:
            _SINKS[event].remove(sink)


def _emit(event: str, payload: dict) -> None:
    with _SINKS_LOCK:
        sinks = list(_SINKS.get(event, []))
        gsinks = list(_GLOBAL_SINKS)
    for s in sinks:
        s(payload)
    for s in gsinks:
        s(event, payload)


class ProgressHandle:
    """Throttled progress emitter with a cancel flag (progress.rs:28-89)."""

    def __init__(self, event: str, total: int = 0):
        self.event = event
        self.total = total
        self._count = 0
        self._last_emit = 0.0
        self._cancelled = threading.Event()
        self._lock = threading.Lock()

    def cancel(self) -> None:
        self._cancelled.set()

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    def check_cancelled(self) -> None:
        if self.is_cancelled():
            raise Cancelled()

    def tick(self, n: int = 1) -> None:
        self.tick_with_stage(None, n)

    def tick_with_stage(self, stage: Optional[str], n: int = 1) -> None:
        with self._lock:
            self._count += n
            now = time.monotonic()
            done = self.total and self._count >= self.total
            if not done and (now - self._last_emit) < EMIT_THROTTLE_S:
                return
            self._last_emit = now
            payload = {"current": self._count, "total": self.total}
            if stage is not None:
                payload["stage"] = stage
        _emit(self.event, payload)

    def emit_stage(self, stage: str) -> None:
        _emit(self.event, {"current": self._count, "total": self.total,
                           "stage": stage})
