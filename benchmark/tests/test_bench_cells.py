"""Every cell's run, at sizes the CPU holds, with the harness's look for
a card skipped: sound, it reads correct; with its timed path broken
underneath it reads not correct, for each fault the cell can have; and
its control (the reference in bfloat16 in the program's place) passes
one of the cell's limits."""

import dataclasses
import importlib
import time

import pytest
import torch

from benchmark.core.harness import run_cell

CPU = torch.device("cpu")
SEED = 3_000_000_019
CELLS = ["nircam16-stack", "ref4096-drizzle", "nircam16-resident",
         "ref4096-open"]


def _run(spec, workload, tmp_path):
    r = run_cell(spec, workload, SEED, 0.3, False, CPU, time.perf_counter(),
                 out_parent=str(tmp_path))
    assert r is not None and r["attempted"] >= 1
    return r


def _patch(monkeypatch, target, make):
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))


def _clip_unchanged(orig):
    def clip(stack, dys, dxs, *a):
        return stack[0].clone(), torch.zeros((), dtype=torch.int64)
    return clip


def _clip_half(orig):
    def clip(stack, dys, dxs, *a):
        h = stack.shape[0] // 2
        return orig(stack[:h].contiguous(), dys[:h], dxs[:h], *a)
    return clip


def _clip_band(orig):
    """A band of half a percent of the rows, over the middle half of the
    columns, 1.5 background sigma off, as a wrong slab or tile would
    leave it: the plane's mean, range, statistics and preview barely
    move."""
    def clip(stack, dys, dxs, *a):
        image, rejected = orig(stack, dys, dxs, *a)
        image = image.clone()
        h, w = image.shape[-2:]
        med = image.median()
        sigma = 1.4826 * (image - med).abs().median()
        image[..., h // 2:h // 2 + max(1, h // 200),
              w // 4:3 * w // 4] += 1.5 * sigma
        return image, rejected
    return clip


def _offset_altered(orig):
    """Frame 1's offset moved by half a pixel where it is produced."""
    def pc(ref, targets, **kw):
        dys, dxs, confs = orig(ref, targets, **kw)
        return dys + (torch.arange(dys.shape[0]) == 0) * 0.5, dxs, confs
    return pc


def _drizzle_unchanged(orig):
    def drz(stack, d_ys, d_xs, scale, pixfrac, kernel, rows, cols, *a, **k):
        img = stack[0].repeat_interleave(2, 0).repeat_interleave(2, 1)
        return img[:rows, :cols].contiguous(), torch.ones_like(
            img[:rows, :cols]), torch.zeros((), dtype=torch.int64)
    return drz


def _drizzle_half(orig):
    def drz(stack, d_ys, d_xs, *a, **k):
        h = stack.shape[0] // 2
        return orig(stack[:h], d_ys[:h], d_xs[:h], *a, **k)
    return drz


def _stats_half(orig):
    def stats(x):
        return orig(x[: x.shape[0] // 2])
    return stats


def _stats_altered(orig):
    def stats(x):
        return dataclasses.replace(orig(x), median=orig(x).median * 1.001)
    return stats


def _stretch_unchanged(orig):
    def stretch(x, params, stats):
        return torch.clamp(x, 0, 255).to(torch.uint8)
    return stretch


CLIP = "astroburst_tpu_torch.stacking.combine:shift_clip_onepass"
PC = "astroburst_tpu_torch.{}:phase_correlate_stack"
PIPE = "astroburst_tpu_torch.parallel.pipeline:shift_clip_onepass"
DRZ = "astroburst_tpu_torch.stacking.drizzle:_drizzle_kernel_exact"
STATS = "astroburst_tpu_torch.api.common:compute_image_stats"
STRETCH = "astroburst_tpu_torch.api.helpers:apply_stf_u8"
FAULTS = [
    ("nircam16-stack", "state unchanged", CLIP, _clip_unchanged),
    ("nircam16-stack", "half the batch", CLIP, _clip_half),
    ("nircam16-stack", "answer altered", PC.format("stacking.combine"),
     _offset_altered),
    ("nircam16-stack", "band altered", CLIP, _clip_band),
    ("ref4096-drizzle", "state unchanged", DRZ, _drizzle_unchanged),
    ("ref4096-drizzle", "half the batch", DRZ, _drizzle_half),
    ("ref4096-drizzle", "answer altered", PC.format("stacking.drizzle"),
     _offset_altered),
    ("nircam16-resident", "state unchanged", PIPE, _clip_unchanged),
    ("nircam16-resident", "half the batch", PIPE, _clip_half),
    ("nircam16-resident", "answer altered",
     PC.format("parallel.pipeline"), _offset_altered),
    ("nircam16-resident", "band altered", PIPE, _clip_band),
    ("ref4096-open", "state unchanged", STRETCH, _stretch_unchanged),
    ("ref4096-open", "half the batch", STATS, _stats_half),
    ("ref4096-open", "answer altered", STATS, _stats_altered),
]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_spec, workload, tmp_path):
    r = _run(tiny_spec, workload, tmp_path)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and "setup_s" in r["metrics"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload,fault,target,make", FAULTS,
                         ids=[f"{w}-{f}" for w, f, _, _ in FAULTS])
def test_fault_reads_not_correct(tiny_spec, workload, fault, target, make,
                                 tmp_path, monkeypatch):
    _patch(monkeypatch, target, make)
    r = _run(tiny_spec, workload, tmp_path)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_passes_a_limit(tiny_spec, workload, tmp_path):
    from benchmark.core.harness import Context
    cell = tiny_spec.cell(workload)
    ctx = Context(cell=cell, seed=SEED, device=CPU,
                  cache_root=str(tmp_path / "cache"),
                  out_root=str(tmp_path / "out"))
    entry = tiny_spec.entry(cell.traffic["entry"]).Entry(ctx)
    try:
        got = entry.compare(entry.reference("bf16"), entry.reference("f32"))
    finally:
        entry.close()
    over = {k: v for k, v in got.items() if v > cell.limits[k]["limit"]}
    assert over, got


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, tmp_path):
    """A short run of each cell at its own size on the card: correct,
    with its end-to-end metrics; ``python -m pytest benchmark -m card``."""
    from benchmark.core.spec import Spec
    spec = Spec()
    r = run_cell(spec, workload, SEED, 2.0, False, card, time.perf_counter(),
                 out_parent=str(tmp_path))
    assert r["correct"], r["checks"]
    assert {m["name"] for m in spec.cell(workload).end_to_end} <= set(
        r["metrics"])
