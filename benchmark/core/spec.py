"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the file its entry names (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``entry``
  names the request it sends: ``benchmark/entries/<entry>.py``;
- a cell's limits on the numbers compared for ``correct``:
  ``benchmark/limits/<workload>.json``;
- a per-layer metric: ``benchmark/metrics/<name>.py``.

A later change adds a configuration, a mix, a cell or a metric as new
files and new entries in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a module named ``name`` (metric
    files have dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict        # the configuration file's content
    traffic: dict       # the traffic file's content
    chips: int
    limits: dict        # number name -> {"limit": ..., ...}
    end_to_end: list    # BENCHMARK.json entries of the cell's metrics
    per_layer: list


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key: str, name: str) -> dict:
        for item in self.data[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.root,
                                      self._named("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "limits",
                                      f"{workload}.json"))["numbers"]

    def entry(self, name: str):
        return load_module(os.path.join(self.bench_dir, "entries",
                                        f"{name}.py"),
                           f"benchmark.entries.{name}")

    def metric(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{name}.py"),
                           f"benchmark_metric_{name.replace('.', '_')}")

    def end_to_end_of(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer_of(self, workload: str) -> list:
        """The per-layer metrics read in ``workload``: those that list
        it, and those without a list whose end-to-end metric the cell
        reports."""
        e2e = {m["name"] for m in self.end_to_end_of(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def cell(self, workload: str) -> Cell:
        w = self._named("workloads", workload)
        return Cell(name=workload, config=self.config(w["config"]),
                    traffic=self.traffic(w["traffic"]), chips=int(w["chips"]),
                    limits=self.limits(workload),
                    end_to_end=self.end_to_end_of(workload),
                    per_layer=self.per_layer_of(workload))
