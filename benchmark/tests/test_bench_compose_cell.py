"""The colour composite cell (``nircam-rgb-swlw-compose``) on the CPU at
a tiny size, with the harness's look for a card skipped and the fused
star chain taken as on the card (its predicate patched): sound, it reads
correct; with the compose broken underneath it reads not correct, for
each fault it can have; its control (the reference in bfloat16 in the
program's place) fails one of its limits and passes another; the
detection's roofline counts the planes' own bytes at full size; and the
files are the configuration's, written once."""

import importlib
import os
import time

import pytest
import torch

from benchmark.core.harness import Context, run_cell

CPU = torch.device("cpu")
CELL = "nircam-rgb-swlw-compose"
CONFIG = "nircam-rgb-swlw"
SEEDS = [3_000_000_019, 2_147_483_659]
# the configuration cut to what the CPU holds: F444W on 192 x 96, F200W
# and F090W on 384 x 192, denser in sources than the full frame
TINY = {"sw_height": 384, "sw_width": 192, "lw_height": 192,
        "lw_width": 96, "stars": 24, "galaxies": 8, "margin_px": 16,
        "nebula_sigma_px": 60.0, "window_px": 12.0}
CHAIN = "astroburst_tpu_torch.alignment.fused_chain"
RGB = "astroburst_tpu_torch.compose.rgb"


@pytest.fixture
def rgb_spec(monkeypatch):
    from benchmark.core.spec import Spec
    spec = Spec()
    full = spec.config

    def config(name):
        c = full(name)
        if name == CONFIG:
            c["data"].update(TINY)
        return c

    spec.config = config
    monkeypatch.setattr(importlib.import_module(CHAIN), "takes_fused_chain",
                        lambda plane: True)
    return spec


def _run(spec, tmp_path, seed=SEEDS[0]):
    r = run_cell(spec, CELL, seed, 0.3, False, CPU, time.perf_counter(),
                 out_parent=str(tmp_path))
    assert r is not None and r["attempted"] >= 1
    return r


def _transform_moved(mod, orig):
    def ransac(*args, **kwargs):
        params, ok, inliers, resid = orig(*args, **kwargs)
        return params + torch.tensor([0, 0, 0.3, 0, 0, 0.2]), ok, inliers, \
            resid
    return ransac


def _no_white_balance(mod, orig):
    return lambda sr, sg, sb: (1.0, 1.0, 1.0)


def _nearest_not_bicubic(mod, orig):
    def resample(image, rows, cols):
        fy, fx = -(-rows // image.shape[0]), -(-cols // image.shape[1])
        return image.repeat_interleave(fy, 0).repeat_interleave(
            fx, 1)[:rows, :cols].contiguous()
    return resample


FAULTS = [(CHAIN, "ransac_device", _transform_moved),
          (RGB, "select_wb_reference", _no_white_balance),
          (RGB, "resample_image", _nearest_not_bicubic)]


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(rgb_spec, seed, tmp_path):
    r = _run(rgb_spec, tmp_path, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert {"setup_s", "command_mpx_per_s"} <= set(r["metrics"])
    assert r["checks"]["not_by_stars"]["value"] == 0


@pytest.mark.parametrize("module,attr,make", FAULTS,
                         ids=[a for _, a, _ in FAULTS])
def test_fault_reads_not_correct(rgb_spec, module, attr, make, tmp_path,
                                 monkeypatch):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(mod, getattr(mod, attr)))
    r = _run(rgb_spec, tmp_path)
    assert not r["correct"], (attr, r["checks"])


def test_the_chain_not_taken_gives_no_result(rgb_spec, tmp_path,
                                             monkeypatch):
    """A port that aligns without the star chain fails in the warm-up,
    before any window."""
    monkeypatch.setattr(importlib.import_module(CHAIN), "takes_fused_chain",
                        lambda plane: False)
    with pytest.raises(RuntimeError, match="fused star chain"):
        run_cell(rgb_spec, CELL, SEEDS[0], 0.3, False, CPU,
                 time.perf_counter(), out_parent=str(tmp_path))


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit_and_passes_another(rgb_spec, seed,
                                                  tmp_path):
    cell = rgb_spec.cell(CELL)
    ctx = Context(cell=cell, seed=seed, device=CPU,
                  cache_root=str(tmp_path / "cache"),
                  out_root=str(tmp_path / "out"))
    entry = rgb_spec.entry(cell.traffic["entry"]).Entry(ctx)
    try:
        got = entry.compare(entry.reference("bf16"), entry.reference("f32"))
    finally:
        entry.close()
    over = {k for k, v in got.items() if v > cell.limits[k]["limit"]}
    assert over and over != set(got), got


def test_roofline_bytes_are_the_planes_own():
    from benchmark.core.spec import Spec
    spec = Spec()
    data = spec.config(CONFIG)["data"]
    detect = spec.metric("alignment.affine.detect.roofline_pct")
    assert detect.op_bytes(data, {}) == 4 * 5655 * 2206
    assert 3 * detect.op_bytes(data, {}) / 1e6 == pytest.approx(149.70,
                                                                abs=5e-3)
    assert detect.SPANS == [f"{CHAIN}:_detect_device"]


def test_the_files_are_the_configurations(rgb_spec, tmp_path):
    """The three files read back as the rendered planes, bit for bit, as
    SCI extensions with the filter's cards; a second call reuses them."""
    from benchmark.core import rgb_fields as F
    from benchmark.reference.fits_image import read_sci_image
    config = rgb_spec.config(CONFIG)
    paths, truth = F.rgb_files(config, SEEDS[0], str(tmp_path), CPU)
    planes, want_truth = F.render(config["data"], SEEDS[0], CPU)
    assert truth == want_truth and set(truth) == {"g", "b"}
    for c, name in (("r", "F444W"), ("g", "F200W"), ("b", "F090W")):
        plane, head = read_sci_image(paths[c])
        assert torch.equal(torch.from_numpy(plane).view(torch.int32),
                           planes[c].view(torch.int32))
        assert head["FILTER"] == name and head["EXTNAME"] == "SCI"
        assert head["BUNIT"] == "MJy/sr"
    stamp = os.stat(paths["r"]).st_mtime_ns
    again, _ = F.rgb_files(config, SEEDS[0], str(tmp_path), CPU)
    assert again == paths and os.stat(paths["r"]).st_mtime_ns == stamp


def test_ransac_keeps_the_outcomes_at_its_thresholds_edge():
    """A match 3.03 px off the transform that 30 exact matches give is an
    outlier in the outcome, and an inlier in the one other outcome kept
    beside it; a match 3.3 px off is in neither."""
    import numpy as np
    from benchmark.reference import compose as R
    rng = np.random.default_rng(5)
    t = (1.0004, -0.004, 12.5, 0.004, 0.9996, -7.25)

    def to(x, y):
        return t[0] * x + t[1] * y + t[2], t[3] * x + t[4] * y + t[5]

    xy = rng.uniform(0, 2000, (34, 2))
    m = np.array([(x, y, *to(x, y)) for x, y in xy])
    m[30:32, 2:] += rng.uniform(40, 90, (2, 2))      # outliers
    m[32, 2] += 3.03                                 # at the edge
    m[33, 3] += 3.3                                  # past it
    out = R.ransac(m, "affine")
    assert [n for _, n, _ in out] == [30, 31]
    assert np.allclose(out[0][0], t, atol=1e-9)
    strict = R._fit_affine(m[:30])
    assert np.allclose(out[0][0], strict, atol=1e-12)
    assert not np.allclose(out[1][0], t, atol=1e-4)


def test_compare_takes_the_nearest_outcome_and_its_colour():
    """The reference's transform of a target is the one of its outcomes
    nearest the program's, and its colour stages are made again with it,
    once for each choice."""
    from benchmark.entries.compose_command import at_edge
    a, b, c = ((1.0, 0.0, 0.0, 0.0, 1.0, 0.0), (1.0, 0.0, 0.5, 0.0, 1.0, 0.0),
               (1.0, 0.0, 0.0, 0.0, 1.0, 2.0))
    made = []

    def finish(ts):
        made.append(ts)
        return {"stats": "again"}

    ref = {"aligned": [("affine", a), ("affine", c)], "edge": [[b], []],
           "finish": finish, "finished": {}, "stats": "first"}
    corners = [(0.0, 0.0), (99.0, 0.0), (0.0, 49.0), (99.0, 49.0)]
    same, ts = at_edge(ref, [a, c], corners)
    assert same is ref and ts == [a, c] and not made
    near_b = (1.0, 0.0, 0.49, 0.0, 1.0, 0.0)
    for _ in range(2):
        got, ts = at_edge(ref, [near_b, c], corners)
        assert ts == [b, c] and got["stats"] == "again"
    assert made == [[b, c]] and ref["stats"] == "first"
