"""One run of one cell: set-up, the measured window, the trace, the
comparison with the plain reference, and the result line.

The cell's traffic file names its entry (``benchmark/entries/``): an
object made once per run that builds the inputs and warms up (set-up),
sends one request at a time, keeps the results of sampled requests,
and compares them with the plain reference after the window. The
loop is closed, with one caller: the next request is sent when the
previous one has returned, as a desktop user waits for each command.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

from benchmark.core import guard
from benchmark.core.spec import Cell, Spec
from benchmark.core.trace import REQUEST, WINDOW

MAX_FAILURES = 3


@dataclass
class Context:
    """What an entry gets to build its inputs and send requests."""
    cell: Cell
    seed: int
    device: object          # torch.device
    cache_root: str         # benchmark/.cache, reused across runs
    out_root: str           # under TMPDIR, removed at the end of the run


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float
    mpx: list                       # input Mpx of each completed request
    trace: object = None            # core.trace.Trace in a traced run
    device_kind: str = ""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def sample_indices(seed: int, expected: int) -> set:
    """The requests whose results are kept and compared, besides the
    last: the first, and one drawn from the seed among the expected
    count."""
    rng = random.Random(seed)
    return {0, rng.randrange(1, max(2, expected))}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, out_parent=None,
             control: bool = False):
    """The result dict of one run, or None when the run may print none
    (the import boundary was crossed). ``control`` adds the control's
    readings (the reference in bfloat16 in the program's place) under
    ``control_checks``, for setting the limits."""
    import torch
    cell = spec.cell(workload)
    bad = guard.reference_violations(os.path.join(spec.bench_dir,
                                                  "reference"))
    if bad:
        log(f"the reference imports the program or JAX: {bad}")
        return None
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    e2e_names = [m["name"] for m in cell.end_to_end]
    layer_names = [m["name"] for m in cell.per_layer]
    readers = {n: spec.metric(n) for n in (layer_names if trace
                                           else e2e_names)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}

    if cuda:
        torch.zeros(1, device=device)     # creates the card's context
    log(f"set-up: torch and the card at {time.perf_counter() - t0:.2f} s")
    out_root = tempfile.mkdtemp(prefix="bench-out-", dir=out_parent)
    ctx = Context(cell=cell, seed=seed, device=device,
                  cache_root=os.path.join(spec.bench_dir, ".cache"),
                  out_root=out_root)
    entry = spec.entry(cell.traffic["entry"]).Entry(ctx)
    try:
        result = _measure(cell, entry, seed, seconds, trace, device, t0,
                          sync, readers, units, torch)
        if result is not None and control:
            ref = entry.reference("f32")
            result["control_checks"] = {
                k: float(v) for k, v in entry.compare(
                    entry.reference("bf16"), ref).items()}
        return result
    finally:
        entry.close()
        shutil.rmtree(out_root, ignore_errors=True)


def _measure(cell, entry, seed, seconds, trace, device, t0, sync, readers,
             units, torch):
    cuda = device.type == "cuda"
    card = power_limit() if cuda else "cpu"
    log(f"card: {card}")
    log(f"set-up: inputs at {time.perf_counter() - t0:.2f} s")
    warm = entry.warm_up()
    log(f"set-up: warmed up at {time.perf_counter() - t0:.2f} s (the "
        f"second warm-up request {warm:.3f} s)")
    est = max(1, int(seconds / max(warm, 1e-3)))
    sample = sample_indices(seed, est)
    found = guard.loaded_forbidden()
    if found:
        log(f"loaded after set-up, not allowed: {found}")
        return None

    spans = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from benchmark.core.trace import Spans
        targets = [t for r in readers.values() for t in getattr(r, "SPANS",
                                                                ())]
        spans = Spans(targets, sync)
        spans.install()
        for t, why in spans.missing:
            log(f"span target {t} is gone ({why}): its metric reads nothing")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kept, failed, attempted, mpx = {}, 0, 0, []
    last = None
    if trace:
        from torch.profiler import record_function
    else:
        def record_function(_name):
            return contextlib.nullcontext()
    sync()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    with record_function(WINDOW):
        while time.perf_counter() - t_start < seconds:
            i = attempted
            attempted += 1
            try:
                with record_function(REQUEST):
                    res = entry.request()
            except Exception:       # a failed request is counted, not fatal
                failed += 1
                log(f"request {i} failed:\n{traceback.format_exc()}")
                if failed >= MAX_FAILURES:
                    break
                continue
            mpx.append(entry.mpx)
            last = (i, res)
            if i in sample:
                kept[i] = entry.keep(res, i)
    t_end = time.perf_counter()
    window_s = t_end - t_start
    if prof is not None:
        prof.stop()
        spans.remove()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = guard.loaded_forbidden()
    if found:
        log(f"loaded by the end of the window, not allowed: {found}")
        return None
    if last is not None and last[0] not in kept:
        kept[last[0]] = entry.keep(last[1], last[0])
    del last
    log(f"window: {len(mpx)} requests completed of {attempted} in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s; kept {sorted(kept)}")

    tr = None
    if trace:
        from benchmark.core.trace import from_profiler
        t_tr = time.perf_counter()
        tr = from_profiler(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t_tr:.1f} s")
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, mpx=mpx,
              trace=tr, device_kind=kind)
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run) if mpx else None
        if value is None or not math.isfinite(value):
            log(f"metric {name}: nothing to read in this run")
            continue
        metrics[name] = {"value": value, "unit": units[name]}

    entry.release()
    sync()
    t_ref = time.perf_counter()
    checks, correct = _check(entry, kept, cell.limits)
    log(f"reference and comparison: {time.perf_counter() - t_ref:.1f} s")
    correct = correct and failed == 0 and bool(mpx)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": kind, "count": cell.chips if cuda else 0,
                         "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return result


def _check(entry, kept: dict, limits: dict):
    """Each number compared, at its worst over the kept requests, beside
    its limit; and whether every one is within it."""
    if not kept:
        return {}, False
    ref = entry.reference("f32")
    worst = {}
    for i in sorted(kept):
        got = entry.outputs(kept[i])
        for name, value in entry.compare(got, ref).items():
            v = float(value)
            if name not in worst or not (v <= worst[name]):
                worst[name] = v
    checks = {}
    for n in limits:
        v = worst.get(n)
        checks[n] = {"value": v if v is not None and math.isfinite(v)
                     else None, "limit": limits[n]["limit"]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return checks, correct


def dumps(result: dict) -> str:
    return json.dumps(result, allow_nan=False)
