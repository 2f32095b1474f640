"""The spans and counters of the RGB compose (``api.compose_rgb_cmd``;
``runtime/trace.py``'s table), on the CPU with the fused star chain
taken (its predicate patched, as on the card): their nesting under one
``api.compose_rgb`` root a command, the counters of the chain's targets
(``alignment.affine.star``, ``.fallback``, ``.inliers``) read from its
one info fetch, still exactly one host fetch with tracing on, the same
results traced and untraced, and nothing kept while tracing is off."""

import json
import os

import numpy as np
import pytest
import torch

from astroburst_tpu_torch import api
from astroburst_tpu_torch.alignment import fused_chain as FC
from astroburst_tpu_torch.compose import rgb as trgb
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from benchmark.core import rgb_fields as F
from benchmark.reference.fits_image import write_sci_image

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"sw_height": 384, "sw_width": 192, "lw_height": 192,
        "lw_width": 96, "stars": 24, "galaxies": 8, "margin_px": 16,
        "nebula_sigma_px": 60.0, "window_px": 12.0}
SEED = 3_000_000_019
STAGES = ["compose.harmonize", "compose.align", "compose.color",
          "compose.preview"]
PARAMS = dict(align=True, align_method="affine", wb_mode="auto",
              auto_stretch=True, linked_stf=False, scnr_enabled=True,
              scnr_method="average", scnr_amount=1.0)


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


@pytest.fixture
def fused(monkeypatch):
    """The fused chain taken on the CPU, as ``process_rgb`` takes it on
    the card."""
    monkeypatch.setattr(FC, "takes_fused_chain", lambda plane: True)


@pytest.fixture(scope="module")
def composite(tmp_path_factory):
    """({channel: path}, {channel: plane}) of a seeded small composite."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "nircam-rgb-swlw.json")) as f:
        config = json.load(f)
    config["data"].update(TINY)
    planes, _ = F.render(config["data"], SEED, CPU)
    d = tmp_path_factory.mktemp("composite")
    paths = {}
    for c, p in planes.items():
        primary, sci = F.fits_cards(config, c)
        paths[c] = str(d / f"{c}.fits")
        write_sci_image(paths[c], p.numpy(), primary, sci)
    return paths, planes


def _compose(paths, out):
    return api.compose_rgb_cmd(str(out), r_path=paths["r"],
                               g_path=paths["g"], b_path=paths["b"],
                               device=CPU, **PARAMS)


def test_spans_nest_under_one_root(composite, tracing, fused, tmp_path):
    paths, _ = composite
    _compose(paths, tmp_path / "a")
    got = trace.drain()
    roots = [s for s in got.spans if s.name == "api.compose_rgb"]
    assert len(roots) == 1 and roots[0].parent == -1
    root = roots[0]
    by = {}
    for s in got.spans:
        by.setdefault(s.name, []).append(s)
    for name in STAGES:
        assert [s.parent for s in by[name]] == [root.id], name
    align = by["compose.align"][0]
    # the reference's detection and the two targets'; the reference's
    # triangles, each target's match and the one fetch; two warps
    assert len(by["alignment.affine.detect"]) == 3
    assert len(by["alignment.affine.match"]) == 4
    assert len(by["alignment.affine.warp"]) == 2
    for name in ("alignment.affine.detect", "alignment.affine.match",
                 "alignment.affine.warp"):
        assert {s.parent for s in by[name]} == {align.id}, name
    color = by["compose.color"][0]
    assert len([s for s in by["stats.core"] if s.parent == color.id]) == 6
    preview = by["compose.preview"][0]
    assert any(s.parent == preview.id for s in by["io.png.deflate"])
    inside = [s for s in got.spans if s.request == root.request]
    assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
               for s in inside)
    assert got.counters["alignment.affine.star"] == 2
    assert "alignment.affine.fallback" not in got.counters
    assert "trace.dropped" not in got.counters


def test_counters_add_up(composite, tracing):
    """One count a target, star or fallback, and the inliers the fetched
    info vectors hold; a plane of noise falls back."""
    _, planes = composite
    r, g, b, *_ = trgb.harmonize_dimensions(planes["r"], planes["g"],
                                            planes["b"])
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        0.1, 0.01, tuple(g.shape)).astype(np.float32))
    out = FC.align_and_warp_many(r, [g, b, noise])
    got = trace.drain().counters
    methods = [res.method for _, res in out]
    assert methods[:2] == ["affine", "affine"]
    assert methods[2] in ("phase_correlation", "identity")
    assert got["alignment.affine.star"] == 2
    assert got["alignment.affine.fallback"] == 1
    assert got["alignment.affine.inliers"] == sum(res.inliers
                                                  for _, res in out[:2])


@pytest.fixture
def fetches(monkeypatch):
    """Counts the calls that bring a tensor's values to the host."""
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__", "nonzero"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


def test_one_host_fetch_with_tracing_on(composite, tracing, fetches):
    """The spans and counters add no fetch: nothing before the info
    fetch reaches the host, and the chain fetches once."""
    _, planes = composite
    r, g, b, *_ = trgb.harmonize_dimensions(planes["r"], planes["g"],
                                            planes["b"])
    fetches.clear()
    stars = FC.detect_ref_stars(r)
    assert fetches == []
    out = FC.align_and_warp_many(r, [g, b], ref_stars=stars)
    assert [res.method for _, res in out] == ["affine", "affine"]
    assert fetches == ["tolist"]
    assert trace.drain().counters["alignment.affine.star"] == 2


def test_same_results_traced_and_untraced(composite, fused, tmp_path):
    paths, _ = composite
    was = trace.enabled()
    trace.disable()
    trace.drain()
    try:
        off = _compose(paths, tmp_path / "off")
        assert trace.drain().spans == []
        planes_off = [GLOBAL_IMAGE_CACHE.get(k, CPU).image for k in (
            "__composite_orig_r", "__composite_orig_g",
            "__composite_orig_b")]
        GLOBAL_IMAGE_CACHE.clear()
        trace.enable()
        on = _compose(paths, tmp_path / "on")
        assert trace.drain().spans
    finally:
        trace.drain()
        if not was:
            trace.disable()
    planes_on = [GLOBAL_IMAGE_CACHE.get(k, CPU).image for k in (
        "__composite_orig_r", "__composite_orig_g", "__composite_orig_b")]
    skip = ("png_path", "elapsed_ms")
    assert {k: v for k, v in off.items() if k not in skip} == \
        {k: v for k, v in on.items() if k not in skip}
    for a, b in zip(planes_off, planes_on):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with open(off["png_path"], "rb") as f1, open(on["png_path"], "rb") as f2:
        assert f1.read() == f2.read()
