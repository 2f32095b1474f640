"""Arithmetic the per-layer metric readers share. A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

from benchmark.core.peaks import PEAKS


def idle_pct(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_ms_per_request(run, targets):
    """Milliseconds inside the spans of ``targets``, over the requests
    of the traced window."""
    tr = run.trace
    if tr is None or tr.n_requests == 0 or not any(
            tr.span_array(t).size for t in targets):
        return None
    return 1e3 * sum(tr.span_total_s(t) for t in targets) / tr.n_requests


def roofline_pct(run, targets, op_bytes):
    """The bytes of every call over the published HBM rate, as a share
    of the device-busy time inside the calls' spans."""
    tr = run.trace
    if tr is None or run.device_kind not in PEAKS:
        return None
    calls = sum(len(tr.span_array(t)) for t in targets)
    busy = sum(tr.span_busy_s(t) for t in targets)
    if calls == 0 or busy <= 0:
        return None
    least = calls * op_bytes(run.cell.config["data"],
                             run.cell.traffic.get("params", {})) \
        / PEAKS[run.device_kind]["hbm_bytes_per_s"]
    return 100.0 * least / busy
