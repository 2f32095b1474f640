"""The IFU cube cell (``ifu-cube-2gib-eager``) on the CPU at a tiny size,
with the harness's look for a card skipped: sound, it reads correct;
with the eager command broken underneath it reads not correct, for each
fault it can have; its control (the reference in bfloat16 in the
program's place) fails one of its limits and passes another; and the
rooflines count the operations' own bytes at full size."""

import importlib
import time

import pytest
import torch

from benchmark.core.harness import Context, run_cell

CPU = torch.device("cpu")
CELL = "ifu-cube-2gib-eager"
SEEDS = [3_000_000_019, 2_147_483_659]
# the configuration cut to what the CPU holds: 16 frames of 4 planes,
# one of them inside the NaN band
TINY = {"depth": 64, "height": 48, "width": 40, "footprint_side": 34,
        "gap_start": 20, "gap_planes": 4, "sources": 6,
        "disc_scale_px": 6.0, "v_turn_px": 3.0}
API = "astroburst_tpu_torch.api.cube"


@pytest.fixture
def cube_spec():
    from benchmark.core.spec import Spec
    spec = Spec()
    full = spec.config

    def config(name):
        c = full(name)
        c["data"].update(TINY)
        return c

    spec.config = config
    return spec


def _run(spec, tmp_path, seed=SEEDS[0]):
    r = run_cell(spec, CELL, seed, 0.3, False, CPU, time.perf_counter(),
                 out_parent=str(tmp_path))
    assert r is not None and r["attempted"] >= 1
    return r


def _median_is_the_mean(api, orig):
    return api.collapse_mean


def _stats_of_half_the_planes(api, orig):
    def stats(cube):
        return orig(cube[: cube.shape[0] // 2])
    return stats


def _nan_passed_as_zero(api, orig):
    def load(path, device):
        header, cube = orig(path, device)
        return header, torch.nan_to_num(cube, nan=0.0)
    return load


def _one_frame_from_the_wrong_plane(api, orig):
    def save(frames_of, depth, frame_step, g, frames_dir):
        step = max(depth // 16, 1)
        return orig(lambda z: frames_of(z + 1 if z == 8 * step else z),
                    depth, frame_step, g, frames_dir)
    return save


FAULTS = [("collapse_median", _median_is_the_mean),
          ("compute_global_stats", _stats_of_half_the_planes),
          ("load_cube", _nan_passed_as_zero),
          ("_save_frames", _one_frame_from_the_wrong_plane)]


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(cube_spec, seed, tmp_path):
    r = _run(cube_spec, tmp_path, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert {"setup_s", "command_mpx_per_s"} <= set(r["metrics"])


@pytest.mark.parametrize("attr,make", FAULTS, ids=[a for a, _ in FAULTS])
def test_fault_reads_not_correct(cube_spec, attr, make, tmp_path,
                                 monkeypatch):
    api = importlib.import_module(API)
    monkeypatch.setattr(api, attr, make(api, getattr(api, attr)))
    r = _run(cube_spec, tmp_path)
    assert not r["correct"], (attr, r["checks"])


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit_and_passes_another(cube_spec, seed,
                                                  tmp_path):
    cell = cube_spec.cell(CELL)
    ctx = Context(cell=cell, seed=seed, device=CPU,
                  cache_root=str(tmp_path / "cache"),
                  out_root=str(tmp_path / "out"))
    entry = cube_spec.entry(cell.traffic["entry"]).Entry(ctx)
    try:
        got = entry.compare(entry.reference("bf16"), entry.reference("f32"))
    finally:
        entry.close()
    over = {k for k, v in got.items() if v > cell.limits[k]["limit"]}
    assert over and over != set(got), got


def test_roofline_bytes_are_the_operations_own():
    from benchmark.core.spec import Spec
    spec = Spec()
    data = spec.config("ifu-cube-2gib")["data"]
    stats = spec.metric("cube.stats.roofline_pct")
    median = spec.metric("cube.median.roofline_pct")
    assert stats.op_bytes(data, {}) == 2 * 4 * 2048 * 512 * 512
    assert stats.op_bytes(data, {}) / 1e9 == pytest.approx(4.2950, abs=5e-5)
    assert median.op_bytes(data, {}) == 4 * (2048 * 512 * 512 + 512 * 512)
    assert median.op_bytes(data, {}) / 1e9 == pytest.approx(2.1485, abs=5e-5)
    assert stats.SPANS == [f"{API}:compute_global_stats"]
    assert median.SPANS == [f"{API}:collapse_median"]


def test_the_cube_file_is_the_configurations(cube_spec, tmp_path):
    """The written file reads back as the rendered cube, bit for bit, as
    the SCI extension with the spectral axis; NaN outside the footprint
    and on the gap's planes, and finite elsewhere."""
    from benchmark.core import cube_fields as F
    from benchmark.reference.fits_cube import read_cube
    config = cube_spec.config("ifu-cube-2gib")
    data = config["data"]
    path = F.write_cube_file(config, SEEDS[0], str(tmp_path), CPU)
    cube, head = read_cube(path)
    want = F.render(data, SEEDS[0], CPU)
    assert torch.equal(torch.from_numpy(cube).view(torch.int32),
                       want.view(torch.int32))
    assert head["EXTNAME"] == "SCI" and head["CTYPE3"] == "WAVE"
    assert head["BUNIT"] == "MJy/sr"
    inside = F.footprint(data, CPU)
    gap = torch.zeros(data["depth"], dtype=torch.bool)
    gap[data["gap_start"]:data["gap_start"] + data["gap_planes"]] = True
    finite = torch.isfinite(want)
    assert not finite[gap].any() and not finite[:, ~inside].any()
    assert finite[~gap][:, inside].all()
    again = F.render(data, SEEDS[0], CPU)
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))
