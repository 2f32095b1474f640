"""Spans and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own files: a metric names the calls it
needs as ``module:attribute`` targets, and the traced run replaces each
attribute, for the window only, by a wrapper that synchronizes the
device, opens a profiler range named ``bench:<target>``, calls the
original and synchronizes again inside the range. ``torch.profiler``
(CPU and CUDA activity) covers the whole window; its events give the
spans, the requests (``bench:request``), the window (``bench:window``)
and every kernel, copy and fill on the device, all on the profiler's
one clock.
"""

from __future__ import annotations

import functools
import importlib
from collections import defaultdict

import numpy as np

PREFIX = "bench:"
WINDOW = PREFIX + "window"
REQUEST = PREFIX + "request"


def resolve(target: str):
    """(module, attribute name) of a ``module:attribute`` target."""
    mod_name, _, attr = target.partition(":")
    mod = importlib.import_module(mod_name)
    if not attr or not hasattr(mod, attr):
        raise AttributeError(f"{mod_name} has no attribute {attr!r}")
    return mod, attr


class Spans:
    """Wraps targets while installed; ``missing`` lists the targets that
    no longer exist (their metrics read nothing)."""

    def __init__(self, targets, sync):
        self.targets = sorted(set(targets))
        self.sync = sync
        self.saved = []
        self.missing = []

    def _wrap(self, orig, label):
        from torch.profiler import record_function
        sync = self.sync

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            sync()
            with record_function(label):
                out = orig(*args, **kwargs)
                sync()
            return out
        return wrapper

    def install(self) -> None:
        for t in self.targets:
            try:
                mod, attr = resolve(t)
            except (ImportError, AttributeError) as exc:
                self.missing.append((t, str(exc)))
                continue
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, PREFIX + t))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved = []


def _kineto_events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event. A
    range opened by ``record_function`` also shows on the device's
    timeline; only kernels, copies and fills count as device work."""
    for e in prof.profiler.kineto_results.events():
        try:
            start, dur = e.start_ns(), e.duration_ns()
        except AttributeError:
            start, dur = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        name = e.name()
        annotation = name.startswith(PREFIX) or (
            hasattr(e, "is_user_annotation") and e.is_user_annotation())
        on_device = str(e.device_type()).endswith("CUDA") and not annotation
        if on_device or not str(e.device_type()).endswith("CUDA"):
            yield name, on_device, start, start + dur


def merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as sorted, disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    return s[new], np.maximum.reduceat(e, first)


class Trace:
    """What one traced window holds, in seconds."""

    def __init__(self, events):
        spans = defaultdict(list)
        dev_s, dev_e, names = [], [], []
        for name, is_dev, s, e in events:
            if is_dev:
                dev_s.append(s)
                dev_e.append(e)
                names.append(name)
            elif name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((s, e))
        window = spans.pop("window", None)
        if not window:
            raise ValueError("the trace holds no window range")
        self.w0, self.w1 = window[0]
        self.requests = np.array(sorted(spans.pop("request", [])),
                                 dtype=np.int64).reshape(-1, 2)
        self.spans = {k: np.array(sorted(v), dtype=np.int64).reshape(-1, 2)
                      for k, v in spans.items()}
        s = np.clip(np.array(dev_s, np.int64), self.w0, self.w1)
        e = np.clip(np.array(dev_e, np.int64), self.w0, self.w1)
        keep = e > s
        self.kernel_s = defaultdict(float)
        for name, d in zip(np.array(names, object)[keep], (e - s)[keep]):
            self.kernel_s[name] += d * 1e-9
        self.ms, self.me = merge(s[keep], e[keep])
        self._cum = np.concatenate([[0], np.cumsum(self.me - self.ms)])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def busy_ns(self, a, b) -> np.ndarray:
        """Device-busy nanoseconds inside each interval [a_i, b_i]."""
        a = np.atleast_1d(np.asarray(a, np.int64))
        b = np.atleast_1d(np.asarray(b, np.int64))
        if self.ms.size == 0:
            return np.zeros(a.shape, np.int64)
        lo = np.searchsorted(self.me, a, side="right")   # first ending > a
        hi = np.searchsorted(self.ms, b, side="left")    # starts before b
        total = self._cum[np.maximum(hi, lo)] - self._cum[lo]
        has = hi > lo
        first = np.minimum(lo, self.ms.size - 1)
        last = np.clip(hi - 1, 0, self.ms.size - 1)
        total = total - np.where(has, np.clip(a - self.ms[first], 0, None), 0)
        total = total - np.where(has, np.clip(self.me[last] - b, 0, None), 0)
        return np.where(has, np.maximum(total, 0), 0)

    @property
    def busy_s(self) -> float:
        return float(self.busy_ns(self.w0, self.w1)[0]) * 1e-9

    def span_array(self, target: str) -> np.ndarray:
        return self.spans.get(target, np.zeros((0, 2), np.int64))

    def span_total_s(self, target: str) -> float:
        sp = self.span_array(target)
        return float((sp[:, 1] - sp[:, 0]).sum()) * 1e-9

    def span_busy_s(self, target: str) -> float:
        sp = self.span_array(target)
        if sp.size == 0:
            return 0.0
        return float(self.busy_ns(sp[:, 0], sp[:, 1]).sum()) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:200], sec] for name, sec in ops]

    def _labels(self, t: np.ndarray) -> np.ndarray:
        """For each time in ``t``: the innermost span open then, else
        whether a request was."""
        labels = np.full(t.shape, "between requests", dtype=object)
        if self.requests.size:
            i = np.searchsorted(self.requests[:, 0], t, side="right") - 1
            inside = (i >= 0) & (self.requests[np.maximum(i, 0), 1] > t)
            labels[inside] = "in a request, outside the spans"
        best = np.full(t.shape, -1, np.int64)
        for target, sp in self.spans.items():
            if sp.size == 0:
                continue
            i = np.searchsorted(sp[:, 0], t, side="right") - 1
            j = np.maximum(i, 0)
            inside = (i >= 0) & (sp[j, 1] > t) & (sp[j, 0] > best)
            labels[inside] = f"in {target}"
            best = np.where(inside, sp[j, 0], best)
        return labels

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time of the window, summed by what the host was
        doing (the innermost span open at each gap's middle)."""
        starts = np.concatenate([[self.w0], self.me])
        ends = np.concatenate([self.ms, [self.w1]])
        gap = ends - starts
        starts, gap = starts[gap > 0], gap[gap > 0]
        by = defaultdict(float)
        for label, g in zip(self._labels(starts + gap // 2), gap):
            by[label] += g * 1e-9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


def from_profiler(prof) -> Trace:
    return Trace(_kineto_events(prof))
