"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Run them from the root of the checkout: ``python -m pytest benchmark``.
Tests that need a CUDA card carry the ``card`` marker and skip inside
the test where there is none.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes the CPU holds: each cell's configuration cut to these
TINY = {"nircam16": {"frames": 4, "height": 600, "width": 300,
                     "stars": 60},
        "ref4096": {"frames": 4, "height": 256, "width": 256,
                    "stars": 60}}


# cells whose files are here but which BENCHMARK.json does not hold yet
# (PERF.md, open questions): the tests still run them
HELD_OUT = [{"name": "nircam16-stack", "config": "nircam16",
             "traffic": "stack-cold", "chips": 1}]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")


@pytest.fixture
def tiny_spec():
    """The benchmark's ``Spec`` with every configuration cut to TINY,
    and the HELD_OUT cells added."""
    from benchmark.core.spec import Spec
    spec = Spec(ROOT)
    names = {w["name"] for w in spec.data["workloads"]}
    spec.data["workloads"] += [w for w in HELD_OUT if w["name"] not in names]
    full = spec.config

    def config(name):
        c = full(name)
        c["data"].update(TINY[name])
        return c

    spec.config = config
    return spec


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
