"""The arithmetic of the metrics, the trace reduction, the roofline byte
counts, and finding every file by the name BENCHMARK.json gives."""

import re

import numpy as np
import pytest

from benchmark.core import stats
from benchmark.core.spec import Spec
from benchmark.core.trace import Trace, merge

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_rate_is_all_work_over_the_window():
    assert stats.rate([199.6] * 30, 12.0) == pytest.approx(499.0)
    with pytest.raises(ValueError):
        stats.rate([1.0], 0.0)


def test_merge_and_busy_time():
    s, e = merge(np.array([50, 120, 600, 950]), np.array([150, 200, 700,
                                                           1200]))
    assert s.tolist() == [50, 600, 950] and e.tolist() == [200, 700, 1200]
    ev = [("bench:window", False, 0, 1000),
          ("bench:request", False, 10, 500),
          ("bench:request", False, 510, 990),
          ("bench:mod:f", False, 100, 300),
          ("k1", True, 50, 150), ("k2", True, 120, 200),
          ("k3", True, 600, 700), ("k1", True, 950, 1200)]
    tr = Trace(ev)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(300e-9)
    assert tr.busy_ns([0, 100, 160], [1000, 160, 650]).tolist() == [300, 60,
                                                                     90]
    assert tr.span_busy_s("mod:f") == pytest.approx(100e-9)
    assert tr.span_total_s("mod:f") == pytest.approx(200e-9)
    assert tr.n_requests == 2
    assert [n for n, _ in tr.device_ops()] == ["k1", "k3", "k2"]
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(700e-9)
    assert set(gaps) == {"in a request, outside the spans"}


def test_idle_gap_takes_the_innermost_span():
    ev = [("bench:window", False, 0, 100), ("bench:request", False, 0, 100),
          ("bench:a:outer", False, 0, 100), ("bench:b:inner", False, 40, 60),
          ("k", True, 0, 40), ("k", True, 60, 100)]
    assert Trace(ev).idle_gaps() == [["in b:inner", pytest.approx(20e-9)]]


def test_roofline_bytes_are_the_operations_own():
    spec = Spec()
    clip = spec.metric("stacking.shift_clip.roofline_pct")
    data = spec.config("nircam16")["data"]
    assert clip.op_bytes(data, {}) == 17 * 5655 * 2206 * 4
    assert clip.op_bytes(data, {}) / 1e6 == pytest.approx(848.3, abs=0.1)
    drz = spec.metric("stacking.drizzle.roofline_pct")
    data = spec.config("ref4096")["data"]
    params = spec.traffic("drizzle-2x")["params"]
    assert drz.op_bytes(data, params) == (10 * 4096 ** 2
                                          + 2 * 8192 ** 2) * 4
    assert drz.op_bytes(data, params) / 1e9 == pytest.approx(1.208,
                                                             abs=0.001)


def test_every_cell_finds_its_files_by_name():
    spec = Spec()
    for w in spec.data["workloads"]:
        cell = spec.cell(w["name"])
        entry = spec.entry(cell.traffic["entry"])
        assert hasattr(entry, "Entry")
        assert cell.limits, w["name"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric(m["name"]).read)
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_benchmark_json_is_well_formed():
    spec = Spec()
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    names = [m["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for m in d[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"])
    with open(spec.root + "/BENCHMARK.json", "rb") as f:
        assert len(f.read()) <= 64 * 1024
