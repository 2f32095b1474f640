"""The per-layer readers of the port's own spans and counters
(``core/program_spans.py``): their arithmetic on a synthetic trace and
synthetic records, spans and counts outside the window dropped, a
missing span or recorder read as None, and ``arm`` leaving the port's
tracing on."""

import pytest

from benchmark.core import program_spans
from benchmark.core.harness import Run
from benchmark.core.spec import Spec
from benchmark.core.trace import Trace

trace = pytest.importorskip("astroburst_tpu_torch.runtime.trace")

READERS = ["stacking.drizzle.busy_pct", "alignment.phase_corr.busy_pct",
           "stats.stf_ms", "io.png.deflate_ms", "io.png.deflate_mb_per_s"]


@pytest.fixture(autouse=True)
def _recorder_state():
    """The port's tracing as it was, and no run remembered."""
    was = trace.enabled()
    program_spans._last[:] = [None, None]
    yield
    program_spans._last[:] = [None, None]
    (trace.enable if was else trace.disable)()


class FakeRecorder:
    def __init__(self, spans=(), counts=()):
        self.spans, self.counts, self.drains = list(spans), list(counts), 0

    def enable(self):
        pass

    def drain(self):
        self.drains += 1
        out = trace.Drained(self.spans, self.counts, {})
        self.spans, self.counts = [], []
        return out


def _span(name, a, b, i=0):
    return trace.Span(i, name, a, b, -1, i, 1)


def _run():
    """A window [0, 1000] ns with two requests; the device busy over
    [50, 200] and [600, 700]."""
    ev = [("bench:window", False, 0, 1000),
          ("bench:request", False, 10, 490),
          ("bench:request", False, 510, 990),
          ("k", True, 50, 150), ("k", True, 120, 200), ("k", True, 600, 700)]
    return Run(cell=None, setup_s=0.0, window_s=1e-6, mpx=[1.0, 1.0],
               trace=Trace(ev))


def _read(monkeypatch, name, spans=(), counts=()):
    rec = FakeRecorder(spans, counts)
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    return Spec().metric(name).read(_run()), rec


@pytest.mark.parametrize("name,span", [
    ("stacking.drizzle.busy_pct", "stacking.drizzle"),
    ("alignment.phase_corr.busy_pct", "alignment.phase_corr")])
def test_busy_pct_is_busy_time_inside_the_spans(monkeypatch, name, span):
    spans = [_span(span, 100, 300), _span(span, 600, 700),
             _span(span, 900, 1100),        # runs past the window: dropped
             _span("other", 0, 1000)]
    value, _ = _read(monkeypatch, name, spans)
    # busy [100, 200] and [600, 700] of 300 ns of spans
    assert value == pytest.approx(100.0 * 200 / 300)


def test_stats_stf_ms_is_the_union_of_both_layers_a_request(monkeypatch):
    spans = [_span("stats.core", 100, 200), _span("stats.stf", 150, 260),
             _span("stats.stf", 600, 640), _span("stats.core", -50, 20)]
    value, _ = _read(monkeypatch, "stats.stf_ms", spans)
    assert value == pytest.approx(1e3 * (160 + 40) * 1e-9 / 2)


def test_deflate_ms_and_rate(monkeypatch):
    spans = [_span("io.png.deflate", 100, 300),
             _span("io.png.deflate", 520, 620),
             _span("io.png.deflate", 1200, 1300)]
    counts = [trace.Count("io.png.raw_bytes", 3000, 150, 0),
              trace.Count("io.png.raw_bytes", 1500, 600, 1),
              trace.Count("io.png.raw_bytes", 9999, 1250, 2),
              trace.Count("io.png.out_bytes", 7, 150, 0)]
    ms, _ = _read(monkeypatch, "io.png.deflate_ms", spans, counts)
    assert ms == pytest.approx(1e3 * 300e-9 / 2)
    program_spans._last[:] = [None, None]
    rate, _ = _read(monkeypatch, "io.png.deflate_mb_per_s", spans, counts)
    assert rate == pytest.approx(4500 / 1e6 / 300e-9)


@pytest.mark.parametrize("name", READERS)
def test_a_missing_span_reads_none(monkeypatch, name):
    spans = [_span("renamed", 100, 300)]
    counts = [trace.Count("io.png.raw_bytes", 10, 150, 0)]
    value, _ = _read(monkeypatch, name, spans, counts)
    assert value is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_recorder_reads_none(monkeypatch, name):
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    assert program_spans.arm() is False
    assert Spec().metric(name).read(_run()) is None


def test_the_recorder_is_drained_once_a_run(monkeypatch):
    rec = FakeRecorder([_span("stats.core", 100, 200)])
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    run = _run()
    spec = Spec()
    first = spec.metric("stats.stf_ms").read(run)
    assert spec.metric("stats.stf_ms").read(run) == first
    assert rec.drains == 1 and first == pytest.approx(1e3 * 100e-9 / 2)


def test_arm_leaves_the_ports_tracing_on():
    trace.disable()
    assert program_spans.arm() is True and trace.enabled()
    for name in READERS:
        trace.disable()
        Spec().metric(name)          # each reader arms when it is loaded
        assert trace.enabled(), name
