"""The port's own spans and counters, as the per-layer readers read them.

The port records spans and counters inside its code
(``astroburst_tpu_torch.runtime.trace``), stamped with
``time.time_ns()``, the clock of the profiler's events: a span and the
device intervals of the run's trace compare directly, and no span
synchronizes the device. A reader that reads them calls ``arm()`` when
it is imported. The harness imports the per-layer readers in a
``--trace 1`` run only, before the entry is built and warmed up, so the
port's tracing is on through the whole traced run and off in every
untraced one.

After the window, the first reader drains the recorder; the spans and
counts that lie inside the traced window ``[run.trace.w0,
run.trace.w1]`` are kept for the run's other readers. A port without
the recorder, or a run whose spans all lie outside the window, reads
nothing: each reader returns None.
"""

from __future__ import annotations

import importlib
from collections import defaultdict

import numpy as np

from benchmark.core.trace import merge

RECORDER = "astroburst_tpu_torch.runtime.trace"

_last = [None, None]    # the run last read, and its window's records


def _recorder():
    try:
        return importlib.import_module(RECORDER)
    except ImportError:
        return None


def arm() -> bool:
    """Turn the port's tracing on; False where the port has no
    recorder."""
    rec = _recorder()
    if rec is None:
        return False
    rec.enable()
    return True


class Window:
    """The port's spans and counts inside one traced window."""

    def __init__(self, drained, w0: int, w1: int):
        spans = defaultdict(list)
        for s in drained.spans:
            if w0 <= s.start_ns and s.end_ns <= w1:
                spans[s.name].append((s.start_ns, s.end_ns))
        self.spans = {k: np.array(sorted(v), np.int64).reshape(-1, 2)
                      for k, v in spans.items()}
        self.counters = defaultdict(int)
        for c in drained.counts:
            if w0 <= c.t_ns <= w1:
                self.counters[c.name] += c.n

    def intervals(self, names):
        """The union of the named spans' intervals: sorted, disjoint
        (starts, ends), or None where no such span lies in the window."""
        found = [self.spans[n] for n in names if n in self.spans]
        if not found:
            return None
        both = np.concatenate(found)
        return merge(both[:, 0], both[:, 1])


def window(run):
    """The run's ``Window``, drained once per run; None without a trace
    or a recorder."""
    if _last[0] is run:
        return _last[1]
    rec = _recorder()
    win = None
    if run.trace is not None and rec is not None:
        win = Window(rec.drain(), run.trace.w0, run.trace.w1)
    _last[:] = [run, win]
    return win


def span_s(run, names):
    """Seconds of the window inside any of the named spans, or None."""
    win = window(run)
    iv = win.intervals(names) if win is not None else None
    if iv is None:
        return None
    starts, ends = iv
    return float((ends - starts).sum()) * 1e-9


def ms_per_request(run, names):
    """``span_s`` in milliseconds over the requests of the window."""
    s = span_s(run, names)
    if s is None or run.trace.n_requests == 0:
        return None
    return 1e3 * s / run.trace.n_requests


def busy_pct(run, name):
    """The share of the named spans' time in which the device was busy
    (the union of kernels, copies and fills of the run's trace)."""
    win = window(run)
    iv = win.intervals([name]) if win is not None else None
    if iv is None:
        return None
    starts, ends = iv
    length = int((ends - starts).sum())
    if length <= 0:
        return None
    return 100.0 * float(run.trace.busy_ns(starts, ends).sum()) / length


def count(run, name):
    """The counter's total inside the window, or None where no count of
    it lies there."""
    win = window(run)
    if win is None or name not in win.counters:
        return None
    return win.counters[name]
