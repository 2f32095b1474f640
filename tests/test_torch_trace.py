"""The port's span and counter recorder (``runtime/trace.py``) and the
spans its main paths record, on the CPU.

- off, ``span`` returns one shared no-op and nothing is kept;
- records: parents, one request under one root, self times that add up,
  a stack per thread, the cap counted in ``trace.dropped``, counts with
  their request;
- the clock is the profiler's: spans around and inside
  ``record_function`` ranges bracket them, in order, within 1 ms;
- each path's spans fire under its root (``process_fits_full``,
  ``align_stack_stretch`` past and below ``COARSE_MAX_DIM``,
  ``_drizzle_kernel_exact``, ``drizzle_stack``), and every traced call
  returns the untraced call's results bit for bit.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from astroburst_tpu_torch import api
from astroburst_tpu_torch.alignment.phase_correlation import COARSE_MAX_DIM
from astroburst_tpu_torch.dtypes import DrizzleConfig, DrizzleKernel
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.stacking import drizzle as drz

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


@pytest.fixture
def tracing():
    """Tracing on and the recorder empty for the test; as it was after."""
    was = trace.enabled()
    trace.drain()
    trace.enable()
    yield
    trace.drain()
    if not was:
        trace.disable()


def _by_id(spans):
    return {s.id: s for s in spans}


def _names(spans):
    return sorted(s.name for s in spans)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _root(spans, name):
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == [name]
    return roots[0]


# ---- the recorder ---------------------------------------------------------


def test_off_records_nothing_and_returns_the_shared_no_op():
    was = trace.enabled()
    trace.disable()
    try:
        trace.drain()
        a, b = trace.span("a"), trace.span("b")
        assert a is b
        with a:
            with b:
                trace.count("c", 5)
        got = trace.drain()
        assert got.spans == [] and got.counts == [] and got.counters == {}
    finally:
        if was:
            trace.enable()


def test_nesting_gives_parents_and_one_request_under_one_root(tracing):
    with trace.span("root"):
        with trace.span("a"):
            with trace.span("b"):
                pass
        with trace.span("c"):
            pass
    with trace.span("second"):
        pass
    spans = trace.drain().spans
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["root", "a", "b", "c", "second"]
    assert by["root"].parent == -1 and by["second"].parent == -1
    assert by["a"].parent == by["root"].id == by["c"].parent
    assert by["b"].parent == by["a"].id
    assert {by[n].request for n in "abc"} == {by["root"].request}
    assert by["second"].request != by["root"].request
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_ident()
        if s.parent != -1:
            p = _by_id(spans)[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_self_times_add_up_to_the_root(tracing):
    with trace.span("root"):
        time.sleep(0.002)
        with trace.span("a"):
            with trace.span("b"):
                time.sleep(0.002)
            time.sleep(0.001)
        with trace.span("c"):
            time.sleep(0.001)
    spans = trace.drain().spans

    def self_ns(s):
        return (s.end_ns - s.start_ns) - sum(
            c.end_ns - c.start_ns for c in _children(spans, s))

    selfs = {s.name: self_ns(s) for s in spans}
    assert all(v >= 0 for v in selfs.values())
    assert selfs["root"] >= 2_000_000 and selfs["b"] >= 2_000_000
    root = _root(spans, "root")
    assert sum(selfs.values()) == root.end_ns - root.start_ns


def test_threads_keep_separate_stacks(tracing):
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with trace.span(f"root{tag}"):
            barrier.wait()          # both roots are open at once
            with trace.span(f"child{tag}"):
                barrier.wait()
            trace.count(f"n{tag}", 1)

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = trace.drain()
    by = {s.name: s for s in got.spans}
    for tag in "xy":
        root, child = by[f"root{tag}"], by[f"child{tag}"]
        assert root.parent == -1 and child.parent == root.id
        assert child.request == root.request and child.thread == root.thread
    assert by["rootx"].request != by["rooty"].request
    assert by["rootx"].thread != by["rooty"].thread
    req = {c.name: c.request for c in got.counts}
    assert req == {"nx": by["rootx"].request, "ny": by["rooty"].request}


def test_the_record_cap_counts_what_it_drops(tracing, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    for name in "abcd":
        with trace.span(name):
            pass
    trace.count("n", 7)
    trace.count("n", 8)
    got = trace.drain()
    assert _names(got.spans) == ["a", "b", "c"] and got.counts == []
    assert got.counters == {"trace.dropped": 3}
    assert trace.drain().counters == {}


def test_counts_sum_by_name_and_carry_their_request(tracing):
    trace.count("bytes", 3)
    with trace.span("root"):
        trace.count("bytes", 4)
        trace.count("calls")
    got = trace.drain()
    root = got.spans[0]
    assert got.counters == {"bytes": 7, "calls": 1}
    assert [(c.name, c.n, c.request) for c in got.counts] == [
        ("bytes", 3, -1), ("bytes", 4, root.request),
        ("calls", 1, root.request)]
    assert all(root.start_ns <= c.t_ns <= root.end_ns
               for c in got.counts[1:])


def test_spans_are_on_the_profiler_clock(tracing):
    from torch.profiler import ProfilerActivity, profile, record_function
    rounds = 20
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # the first range sets up
            torch.ones(64).sum()
        for i in range(rounds):
            with trace.span("outer"):
                with record_function(f"range{i}"):
                    with trace.span("inner"):
                        torch.ones(64).sum()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("range"):
            ranges[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    spans = trace.drain().spans
    outer = [s for s in spans if s.name == "outer"]
    inner = [s for s in spans if s.name == "inner"]
    assert len(ranges) == len(outer) == len(inner) == rounds
    gaps = []
    for i, (o, n) in enumerate(zip(outer, inner)):
        r0, r1 = ranges[f"range{i}"]
        assert o.start_ns <= r0 <= n.start_ns <= n.end_ns <= r1 <= o.end_ns
        gaps.append([r0 - o.start_ns, n.start_ns - r0, r1 - n.end_ns,
                     o.end_ns - r1])
    # each stamp within 1 ms of the next (the median round: a round the
    # scheduler interrupts may take longer, and is still in order)
    assert (np.median(gaps, axis=0) < 1_000_000).all(), gaps


# ---- the paths ------------------------------------------------------------


def _fits(tmp_path, shape=(120, 200)):
    rng = np.random.default_rng(21)
    x = rng.normal(100.0, 5.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.01] = np.nan
    path = os.path.join(tmp_path, "field.fits")
    write_fits_mono(path, x)
    return path


def _frames(shape, seed=5):
    """Frames of a star field, each moved by a whole-pixel dither."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    base = rng.normal(100.0, 3.0, (h, w)).astype(np.float32)
    for y, x in rng.integers(8, min(h, w) - 8, (40, 2)):
        base[y - 2:y + 3, x - 2:x + 3] += 400.0
    frames = [np.roll(base, (3 * k, -2 * k), (0, 1)) for k in range(n)]
    return torch.from_numpy(np.stack(frames)
                            + rng.normal(0.0, 1.0, shape).astype(np.float32))


def test_process_fits_full_spans(tmp_path, tracing):
    path = _fits(tmp_path)
    trace.drain()                    # the file's own write
    api.process_fits_full(path, str(tmp_path), device=CPU)
    got = trace.drain()
    root = _root(got.spans, "api.process_fits_full")
    assert {s.request for s in got.spans} == {root.request}
    assert {s.name for s in _children(got.spans, root)} == {
        "io.decode", "io.upload", "stats.core", "stats.stf", "io.fetch",
        "io.png.scanlines", "io.png.deflate", "io.write", "stats.histogram"}
    assert got.counters["io.png.raw_bytes"] == 120 * (200 + 1)
    assert 0 < got.counters["io.png.out_bytes"]
    assert got.counters["io.decode_bytes"] == 120 * 200 * 4


@pytest.mark.parametrize("shape", [(COARSE_MAX_DIM + 88, 520), (200, 240)])
def test_align_stack_stretch_spans(shape, tracing):
    align_stack_stretch(_frames((3, *shape)))
    spans = trace.drain().spans
    root = _root(spans, "pipeline.align_stack_stretch")
    assert [s.name for s in _children(spans, root)] == [
        "alignment.phase_corr", "stacking.shift_clip", "stats.core",
        "stats.stf"]
    pc = _children(spans, root)[0]
    # below COARSE_MAX_DIM on both axes the correlation is one scale:
    # no coarse surfaces (K1) and no refine crops (K2)
    want = (["alignment.coarse", "alignment.correlate", "alignment.crops",
             "alignment.correlate"] if max(shape) > COARSE_MAX_DIM
            else ["alignment.correlate"])
    assert [s.name for s in _children(spans, pc)] == want


def _drizzle_args():
    stack = _frames((3, 40, 48))
    d_ys = torch.tensor([0.0, -0.25, 0.5])
    d_xs = torch.tensor([0.0, 0.3, -0.6])
    return (stack, d_ys, d_xs, 2.0, 0.7, DrizzleKernel.SQUARE, 80, 96, 3.0,
            3.0, 5)


def test_drizzle_bands_each_record_their_steps(tracing):
    """80 output rows from row 40 in bands of 24: 4 bands, counted, all
    made by one tap pass and one gather."""
    drz._drizzle_kernel_exact(*_drizzle_args(), band_rows=24,
                              row0_offset=40)
    got = trace.drain()
    root = _root(got.spans, "stacking.drizzle")
    assert got.counters == {"stacking.drizzle.bands": 4}
    assert [s.name for s in _children(got.spans, root)] == [
        "stacking.drizzle.taps", "stacking.drizzle.gather"]


def test_drizzle_one_launch_records_one_step_each(tracing):
    drz._drizzle_kernel_exact(*_drizzle_args(), band_rows=16)
    got = trace.drain()
    root = _root(got.spans, "stacking.drizzle")
    assert got.counters == {"stacking.drizzle.bands": 5}
    assert [s.name for s in _children(got.spans, root)] == [
        "stacking.drizzle.taps", "stacking.drizzle.gather"]
    # called directly, the route records the same steps and count
    drz._drizzle_one_launch(*_drizzle_args(), 16, 0)
    got = trace.drain()
    assert [s.name for s in got.spans] == [
        "stacking.drizzle.taps", "stacking.drizzle.gather"]
    assert got.counters == {"stacking.drizzle.bands": 5}


def test_drizzle_stack_spans(tracing):
    frames = list(_frames((3, 64, 72)))
    drz.drizzle_stack(frames, DrizzleConfig(scale=2.0, pixfrac=0.7),
                      device=CPU)
    spans = trace.drain().spans
    root = _root(spans, "stacking.drizzle_stack")
    assert [s.name for s in _children(spans, root)] == [
        "alignment.phase_corr", "stacking.drizzle"]


def _same(a, b):
    """Tensors, arrays and containers of them equal bit for bit (NaN
    payloads and the sign of zero too)."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.reshape(-1).view(torch.uint8).equal(
                    b.reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def _open(tmp_path):
    path = _fits(tmp_path)
    out = str(tmp_path)
    GLOBAL_IMAGE_CACHE.clear()
    res = api.process_fits_full(path, out, device=CPU)
    res.pop("elapsed_ms")
    with open(res["png_path"], "rb") as f:
        res["png"] = f.read()
    return res


def _stretch(tmp_path):
    return align_stack_stretch(_frames((3, COARSE_MAX_DIM + 88, 520)))


def _drizzle_kernel_exact(tmp_path):
    return drz._drizzle_kernel_exact(*_drizzle_args(), band_rows=24,
                                     row0_offset=40)


def _drizzle_one_launch(tmp_path):
    return drz._drizzle_one_launch(*_drizzle_args(), 16, 0)


def _drizzle_stack(tmp_path):
    res = drz.drizzle_stack(list(_frames((3, 64, 72))),
                            DrizzleConfig(scale=2.0, pixfrac=0.7),
                            device=CPU)
    return vars(res)


@pytest.mark.parametrize("call", [_open, _stretch, _drizzle_kernel_exact,
                                  _drizzle_stack, _drizzle_one_launch],
                         ids=["process_fits_full", "align_stack_stretch",
                              "drizzle_kernel_exact", "drizzle_stack",
                              "drizzle_one_launch"])
def test_traced_call_is_bit_equal_to_untraced(call, tmp_path):
    was = trace.enabled()
    trace.disable()
    try:
        plain = call(tmp_path)
        trace.enable()
        traced = call(tmp_path)
        assert trace.drain().spans
    finally:
        trace.drain()
        if not was:
            trace.disable()
    assert _same(plain, traced)
