"""The import boundary: nothing the benchmark runs loads JAX or the JAX
package, the reference imports nothing of the port, and a run without
a card (or without the port) prints no result."""

import os
import shutil
import subprocess
import sys

from benchmark.core import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_violations(
        os.path.join(ROOT, "benchmark", "reference")) == []


def test_names_are_compared_whole():
    assert guard.loaded_forbidden(["astroburst_tpu_torch",
                                   "astroburst_tpu_torch.api", "jaxtyping",
                                   "numpy"]) == []
    assert guard.loaded_forbidden(["astroburst_tpu.api", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "astroburst_tpu", "flax", "jax", "jaxlib"]
    assert guard.imported_names("import jax.numpy as jnp\n"
                                "from astroburst_tpu_torch.api import x\n"
                                "from . import y\n") == {
        "jax", "astroburst_tpu_torch"}


def test_what_a_run_imports_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.core.spec import Spec\n"
            "import benchmark.core.harness, benchmark.core.trace\n"
            "spec = Spec()\n"
            "for w in spec.data['workloads']:\n"
            "    c = spec.cell(w['name'])\n"
            "    spec.entry(c.traffic['entry'])\n"
            "    [spec.metric(m['name']) for m in c.end_to_end + c.per_layer]\n"
            "import astroburst_tpu_torch.api, astroburst_tpu_torch.parallel\n"
            "from benchmark.core.guard import loaded_forbidden\n"
            "print(loaded_forbidden())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_when_jax_loads_after_the_window(tiny_spec, tmp_path,
                                                 monkeypatch, capsys):
    """A module of JAX that the reference or the comparison loads, after
    the window's own look, still keeps the result from being printed."""
    import time
    import types

    import torch

    from benchmark import run
    from benchmark.core import harness

    check = harness._check

    def check_loading_jax(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(*a, **k)

    monkeypatch.setattr(harness, "_check", check_loading_jax)
    result = harness.run_cell(tiny_spec, "ref4096-open", 3_000_000_021,
                              0.2, False, torch.device("cpu"),
                              time.perf_counter(), out_parent=str(tmp_path))
    assert result is not None and "jax" in sys.modules
    capsys.readouterr()
    assert run.emit(result) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ref4096-open",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
