"""The full-resolution masked-stretch cell (``nircam-fullres-masked``) on
the CPU at a cut size, with the harness's look for a card skipped: sound,
it reads correct; with the JAX package's caps forced back (1024 peaks,
512 conflicted candidates), or the mask painted from too few stars, it
reads not correct; its control (the reference in bfloat16 in the
program's place) fails one of its limits and passes another; the two
rooflines count the planes' own bytes at full size; and the files are
the configuration's, on one grid."""

import importlib
import time

import pytest
import torch

from benchmark.core.harness import Context, run_cell

CPU = torch.device("cpu")
CELL = "nircam-fullres-masked"
CONFIG = "nircam-fullres-rgb"
SEEDS = [3_000_000_019, 2_147_483_659]
# the configuration cut to what the CPU holds, with more candidates
# than the JAX package's 1024 peaks
CUT = {"sw_height": 1024, "sw_width": 896, "stars": 1500, "galaxies": 60,
       "margin_px": 16, "nebula_sigma_px": 200.0, "window_px": 10.0}
MS = "astroburst_tpu_torch.imaging.masked_stretch"


@pytest.fixture
def masked_spec():
    from benchmark.core.spec import Spec
    spec = Spec()
    full = spec.config

    def config(name):
        c = full(name)
        if name == CONFIG:
            c["data"].update(CUT)
        return c

    spec.config = config
    return spec


def _run(spec, tmp_path, seed=SEEDS[0]):
    r = run_cell(spec, CELL, seed, 0.3, False, CPU, time.perf_counter(),
                 out_parent=str(tmp_path))
    assert r is not None and r["attempted"] >= 1
    return r


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(masked_spec, seed, tmp_path):
    r = _run(masked_spec, tmp_path, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert {"setup_s", "command_mpx_per_s"} <= set(r["metrics"])
    assert r["checks"]["iterations_mismatch"]["value"] == 0


def _jax_caps(mod, orig):
    def star_mask_device(image, cfg, max_peaks=None, scan_cap=None):
        return orig(image, cfg, 1024, 512)
    return star_mask_device


def _every_other_star(mod, orig):
    def paint_records(packed, cfg, scan_cap=None):
        xs, ys, radii, n = orig(packed, cfg, scan_cap)
        drop = torch.arange(radii.shape[0]) % 2 == 1
        radii = torch.where(drop, 0.0, radii)
        return xs, ys, radii, (radii > 0).sum()
    return paint_records


@pytest.mark.parametrize("attr,make", [("star_mask_device", _jax_caps),
                                       ("_paint_records", _every_other_star)],
                         ids=["jax-caps", "half-the-stars"])
def test_fault_reads_not_correct(masked_spec, attr, make, tmp_path,
                                 monkeypatch):
    mod = importlib.import_module(MS)
    monkeypatch.setattr(mod, attr, make(mod, getattr(mod, attr)))
    r = _run(masked_spec, tmp_path)
    assert not r["correct"], (attr, r["checks"])
    assert r["checks"]["stars_rel"]["value"] > \
        r["checks"]["stars_rel"]["limit"]


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit_and_passes_another(masked_spec, seed,
                                                  tmp_path):
    cell = masked_spec.cell(CELL)
    ctx = Context(cell=cell, seed=seed, device=CPU,
                  cache_root=str(tmp_path / "cache"),
                  out_root=str(tmp_path / "out"))
    entry = masked_spec.entry(cell.traffic["entry"]).Entry(ctx)
    try:
        ref = entry.reference("f32")
        got = entry.compare(entry.reference("bf16"), ref)
    finally:
        entry.close()
    assert ref["candidates"] > 1024 and ref["stars"] > 1024
    over = {k for k, v in got.items() if v > cell.limits[k]["limit"]}
    assert over and over != set(got), got


def test_roofline_bytes_are_the_planes_own():
    from benchmark.core.spec import Spec
    spec = Spec()
    data = spec.config(CONFIG)["data"]
    px = 13759 * 12451
    mask = spec.metric("imaging.star_mask.roofline_pct")
    assert mask.op_bytes(data, {}) == 8 * px
    assert mask.op_bytes(data, {}) / 1e9 == pytest.approx(1.37, abs=5e-3)
    assert mask.SPANS == ["astroburst_tpu_torch.imaging.star_mask:"
                          "_mask_kernel"]
    mtf = spec.metric("stretch.masked.mtf.roofline_pct")
    # three loops that stop after 3 iterations: normalisation 8, three
    # medians 24, the two blends kept 24; no final median
    assert mtf.op_bytes(data, 3, 9, 0) == 3 * (8 + 24 + 24) * px
    # one that runs out after 10: 8 + 80 + 10 blends 120 + final median 8
    assert mtf.op_bytes(data, 1, 10, 1) == (8 + 80 + 120 + 8) * px
    assert mtf.op_bytes(data, 3, 12, 1) == \
        mtf.op_bytes(data, 2, 2, 0) + mtf.op_bytes(data, 1, 10, 1)
    assert mtf.op_bytes(data, 6, 30, 2) == 2 * mtf.op_bytes(data, 3, 15, 1)


def test_the_files_are_the_configurations(masked_spec, tmp_path):
    """Three planes on one grid with one NaN footprint, each its
    filter's SCI extension, the same sky in each (no misregistration)."""
    import numpy as np
    from benchmark.core import rgb_fields as F
    from benchmark.reference.fits_image import read_sci_image
    config = masked_spec.config(CONFIG)
    paths, truth = F.rgb_files(config, SEEDS[0], str(tmp_path), CPU)
    assert all(t == [1.0, -0.0, 0.0, 0.0, 1.0, 0.0] for t in truth.values())
    nan = None
    for c, name in (("r", "F200W"), ("g", "F150W"), ("b", "F115W")):
        plane, head = read_sci_image(paths[c])
        assert plane.shape == (1024, 896)
        assert head["FILTER"] == name and head["CHANNEL"] == "SHORT"
        nan = np.isnan(plane) if nan is None else nan
        assert np.array_equal(np.isnan(plane), nan)
    assert 0.02 < nan.mean() < 0.2
