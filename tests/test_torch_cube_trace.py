"""The spans and the counter of the eager cube command
(``api.process_cube_cmd``; ``runtime/trace.py``'s table), on the CPU:
their names and nesting under one ``api.process_cube`` root per command,
``cube.load_bytes`` = 4 * D * H * W (the f32 bytes put on the device,
whatever the file's BITPIX), the same results traced and untraced, and
nothing kept while tracing is off."""

import os

import numpy as np
import pytest
import torch

from astroburst_tpu_torch import api
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from benchmark.reference.fits_cube import CubeWriter

CPU = torch.device("cpu")
SHAPE = (48, 20, 16)
STAGES = ["cube.load", "cube.stats", "cube.collapse", "cube.previews"]
NAMES = {"api.process_cube", "cube.load_bytes", *STAGES}


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


def _cube_file(tmp_path, bitpix=-32, name="cube"):
    rng = np.random.default_rng(5)
    cube = rng.normal(10.0, 2.0, SHAPE).astype(np.float32)
    cube[:, :3] = np.nan
    path = str(tmp_path / f"{name}.fits")
    cards = [("CTYPE3", "'WAVE'"), ("CRVAL3", "2.87"), ("CDELT3", "0.01")]
    if bitpix == 16:
        with CubeWriter(path, SHAPE, cards + [("BZERO", "3.0")],
                        bitpix=16) as w:
            w.write(np.nan_to_num(cube).astype(np.int16))
    else:
        with CubeWriter(path, SHAPE, cards, primary_cards=[]) as w:
            w.write(cube)
    return path


def _ancestors(span, by_id):
    names = []
    while span.parent != -1:
        span = by_id[span.parent]
        names.append(span.name)
    return names


def test_stages_nest_under_one_root(tmp_path, tracing):
    path = _cube_file(tmp_path)
    api.process_cube_cmd(path, str(tmp_path / "out"), device=CPU)
    got = trace.drain()
    roots = [s for s in got.spans if s.name == "api.process_cube"]
    assert len(roots) == 1 and roots[0].parent == -1
    root = roots[0]
    mine = [s for s in got.spans if s.thread == root.thread]
    assert {s.request for s in mine} == {root.request}
    stages = [s for s in mine if s.parent == root.id]
    assert [s.name for s in stages] == STAGES
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
               for s in got.spans)
    by_id = {s.id: s for s in got.spans}
    decode = [s for s in mine if s.name == "io.decode"]
    assert decode and all(by_id[s.parent].name == "cube.load"
                          for s in decode)
    # the two collapses' PNGs on the caller's thread, under the previews
    # (the frames' PNGs are encoded on a pool, each its own root there)
    deflate = [s for s in mine if s.name == "io.png.deflate"]
    assert len(deflate) == 2
    assert all("cube.previews" in _ancestors(s, by_id) for s in deflate)
    frames = [s for s in got.spans if s.name == "io.png.deflate"
              and s.thread != root.thread]
    assert len(frames) == len(range(0, SHAPE[0], SHAPE[0] // 16))


@pytest.mark.parametrize("bitpix", [-32, 16])
def test_load_bytes_are_the_f32_cube_on_the_device(tmp_path, tracing,
                                                   bitpix):
    path = _cube_file(tmp_path, bitpix)
    for i in range(2):
        api.process_cube_cmd(path, str(tmp_path / f"out{i}"), device=CPU)
    got = trace.drain()
    counts = [c for c in got.counts if c.name == "cube.load_bytes"]
    assert [c.n for c in counts] == [4 * np.prod(SHAPE)] * 2
    assert got.counters["cube.load_bytes"] == 8 * np.prod(SHAPE)
    roots = {s.request for s in got.spans if s.name == "api.process_cube"}
    assert {c.request for c in counts} == roots and len(roots) == 2
    assert "trace.dropped" not in got.counters


def _outputs(res):
    skip = {"elapsed_ms", "collapsed_path", "collapsed_median_path",
            "frames_dir"}
    pngs = [res["collapsed_path"], res["collapsed_median_path"]] + [
        os.path.join(res["frames_dir"], n)
        for n in sorted(os.listdir(res["frames_dir"]))]
    blobs = []
    for p in pngs:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return {k: v for k, v in res.items() if k not in skip}, blobs


def test_traced_results_equal_untraced(tmp_path):
    path = _cube_file(tmp_path)
    was = trace.enabled()
    try:
        trace.disable()
        off = _outputs(api.process_cube_cmd(path, str(tmp_path / "off"),
                                            device=CPU))
        trace.drain()
        trace.enable()
        on = _outputs(api.process_cube_cmd(path, str(tmp_path / "on"),
                                           device=CPU))
        assert {s.name for s in trace.drain().spans} >= NAMES - {
            "cube.load_bytes"}
    finally:
        (trace.enable if was else trace.disable)()
    assert str(on[0]) == str(off[0]) and on[1] == off[1]


def test_off_records_nothing(tmp_path):
    path = _cube_file(tmp_path)
    was = trace.enabled()
    try:
        trace.disable()
        trace.drain()
        api.process_cube_cmd(path, str(tmp_path / "out"), device=CPU)
        got = trace.drain()
    finally:
        (trace.enable if was else trace.disable)()
    assert got.spans == [] and got.counts == [] and got.counters == {}
