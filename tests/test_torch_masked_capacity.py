"""PyTorch port: the masked stretch masks every star its detection keeps
(ROADMAP C49), on the CPU (the kernels' plain versions).

- ``peak_capacity`` and ``_detect(..., None)``: the capacity follows
  the candidates' count, so none is dropped;
- ``dedupe_packed_device`` at K > 4096: the accept set equal to
  ``_postprocess_packed``'s (the host greedy) on clusters inside 3 px,
  pairs exactly 3 px apart and candidates on one spot; on detection
  records, whose twin peaks carry equal fluxes, equal to the stable
  host greedy of the benchmark's reference; with ``scan_cap`` the
  dimmest conflicted ones past the cap dropped;
- ``masked_stretch_composite_cmd`` with the shared mask on a crowded
  1536² composite with more than 4096 candidates against the
  benchmark's plain reference (``benchmark/reference/masked_stretch``):
  the stars masked, every channel's iterations, convergence and final
  background equal, the coverage within 1e-7 (the port divides in f32),
  the preview PNG equal; the per-channel form masks as many in each
  channel as ``masked_stretch`` does alone;
- the command's spans and counters (``runtime/trace.py``'s table).
"""

import numpy as np
import pytest
import torch

from astroburst_tpu_torch import api
from astroburst_tpu_torch.analysis import star_detection as SD
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.imaging import masked_stretch
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from benchmark.reference import masked_stretch as R
from benchmark.reference.png import decode_png

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


@pytest.mark.parametrize("n,k", [(0, 1024), (1, 1024), (1024, 1024),
                                 (1025, 2048), (42391, 43008)])
def test_peak_capacity_holds_every_candidate(n, k):
    assert SD.peak_capacity(n) == k
    assert SD.peak_capacity(torch.tensor(n)) == k


def _crowded(h, w, n, seed, pairs=300):
    """A field of n Gaussian stars (sigma 1.1 px, peaks 0.05-0.8) on 0.1
    with noise 0.004, and ``pairs`` more stars 1-2.9 px from one of
    them; f32."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(6, h - 6, n)
    xs = rng.uniform(6, w - 6, n)
    pick = rng.integers(0, n, pairs)
    ang = rng.uniform(0, 2 * np.pi, pairs)
    sep = rng.uniform(1.0, 2.9, pairs)
    ys = np.concatenate([ys, ys[pick] + sep * np.sin(ang)])
    xs = np.concatenate([xs, xs[pick] + sep * np.cos(ang)])
    amp = np.exp(rng.uniform(np.log(0.05), np.log(0.8), ys.size))
    img = rng.normal(0.1, 0.004, (h, w))
    off = np.arange(-6, 7)
    iy = np.round(ys).astype(int)[:, None, None] + off[:, None]
    ix = np.round(xs).astype(int)[:, None, None] + off[None, :]
    val = amp[:, None, None] * np.exp(
        -((iy - ys[:, None, None]) ** 2 + (ix - xs[:, None, None]) ** 2)
        / (2 * 1.1 ** 2))
    np.add.at(img, (np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)), val)
    return img.astype(np.float32)


def test_detect_without_a_cap_keeps_every_candidate():
    img = torch.from_numpy(_crowded(768, 640, 1800, 4))
    tile = SD._tile_size(768, 640)
    packed = SD._detect(img, tile, 5.0, None)
    live = int((packed[6] > 0).sum())
    assert live > 1024 and packed.shape[1] == SD.peak_capacity(live)
    capped = SD._detect(img, tile, 5.0, SD.MAX_PEAKS)
    assert int((capped[6] > 0).sum()) == SD.MAX_PEAKS
    # the capped record is the uncapped one's first MAX_PEAKS slots
    assert torch.equal(capped[:9], packed[:9, :SD.MAX_PEAKS])


def _packed(rng, k):
    """[10, k] packed records: clusters of 2-12 candidates inside 3 px,
    pairs exactly 3 px apart, candidates on one spot, isolated ones,
    invalid slots with NaN positions."""
    ys, xs = [], []
    for _ in range(600):
        cy, cx = rng.uniform(10, 4000, 2)
        for _ in range(rng.integers(2, 13)):
            ys.append(cy + rng.uniform(-3, 3))
            xs.append(cx + rng.uniform(-3, 3))
    for _ in range(100):
        cy, cx = np.float32(rng.uniform(10, 4000, 2))
        ys += [cy, cy + np.float32(3.0), cy]
        xs += [cx, cx, cx]
    while len(ys) < k - 64:
        ys.append(rng.uniform(0, 4096))
        xs.append(rng.uniform(0, 4096))
    n = len(ys)
    packed = np.zeros((10, k), np.float32)
    packed[0, :n], packed[1, :n] = ys, xs
    packed[0, n:] = packed[1, n:] = np.nan
    packed[2] = rng.uniform(1.0, 100.0, k)
    packed[3] = rng.uniform(1.0, 5.0, k)
    packed[8, :n] = rng.random(n) < 0.95
    perm = rng.permutation(k)
    packed[:9] = packed[:9, perm]
    return packed


@pytest.mark.parametrize("seed", [0, 1])
def test_dedupe_matches_the_host_greedy_past_4096(seed):
    packed = _packed(np.random.default_rng(seed), 8192)
    got = SD.dedupe_packed_device(torch.from_numpy(packed.copy())).numpy()
    det = SD._postprocess_packed(packed, 5.0, 4096, 4096)
    want = sorted((np.float32(s.y), np.float32(s.x)) for s in det.stars)
    assert sorted(zip(packed[0, got], packed[1, got])) == want
    assert len(want) > 4096
    valid = packed[8] > 0.5
    assert got.sum() < valid.sum() - 500      # many were suppressed


def test_dedupe_keeps_the_stable_greedys_twin_on_detections():
    """Two peaks of one component give equal fluxes; the dedupe keeps the
    first in candidate order, as the stable host greedy of the
    benchmark's reference does."""
    img = torch.from_numpy(_crowded(1024, 896, 3500, 5))
    packed = SD._detect(img, SD._tile_size(1024, 896), 5.0, None)
    got = SD.dedupe_packed_device(packed).numpy()
    host = packed.numpy()
    valid = np.flatnonzero(host[8] > 0.5)
    kept = valid[R.dedupe(host[0, valid], host[1, valid], host[2, valid])]
    assert sorted(np.flatnonzero(got)) == sorted(kept)
    fl = host[2, valid]
    assert len(np.unique(fl)) < len(fl)           # twins are there


def test_dedupe_scan_cap_drops_the_dimmest_conflicted():
    packed = _packed(np.random.default_rng(2), 8192)
    full = SD.dedupe_packed_device(torch.from_numpy(packed.copy())).numpy()
    capped = SD.dedupe_packed_device(torch.from_numpy(packed.copy()),
                                     scan_cap=512).numpy()
    assert not (capped & ~full).any() and capped.sum() < full.sum()


def _seed(planes):
    tensors = [torch.from_numpy(p) for p in planes]
    helpers.insert_composite_and_orig(
        *tensors, *(compute_image_stats(t) for t in tensors))
    return tensors


def test_shared_command_matches_the_plain_reference(tmp_path):
    base = _crowded(1536, 1536, 5200, 7)
    rng = np.random.default_rng(8)
    planes = [np.clip(base * s + rng.normal(0, 0.002, base.shape), 0, None)
              .astype(np.float32) for s in (1.0, 0.8, 1.2)]
    planes[1][:40, :60] = np.nan
    tensors = _seed(planes)
    got = api.masked_stretch_composite_cmd(str(tmp_path), shared_mask=True,
                                           device=CPU)
    mask = R.star_mask(R.luminance(*tensors))
    assert mask["candidates"] > 4096 and mask["stars"] > 4096
    assert got["stars_masked"] == mask["stars"]
    assert got["mask_coverage"] == pytest.approx(mask["coverage"], abs=1e-7)
    preview = []
    for c, t in zip("rgb", tensors):
        want = R.stretch(t, mask["mask"])
        preview.append(R.to_u8(R.nearest_downsample(want.pop("image"),
                                                    R.PREVIEW_MAX)))
        assert got["channels"][c] == want
    np.testing.assert_array_equal(decode_png(got["png_path"]),
                                  torch.stack(preview, -1).numpy())


def test_per_channel_command_masks_each_channel(tmp_path):
    planes = [_crowded(768, 640, 1500, s) for s in (11, 12, 13)]
    tensors = _seed(planes)
    got = api.masked_stretch_composite_cmd(str(tmp_path), device=CPU)
    alone = [masked_stretch(t) for t in tensors]
    assert got["stars_masked"] == sum(a.stars_masked for a in alone)
    assert min(a.stars_masked for a in alone) > 1024


def test_command_spans_and_counters(tmp_path):
    _seed([_crowded(384, 320, 150, s) for s in (21, 22, 23)])
    trace.drain()
    trace.enable()
    try:
        got = api.masked_stretch_composite_cmd(str(tmp_path),
                                               shared_mask=True, device=CPU)
        drained = trace.drain()
    finally:
        trace.disable()
    names = [s.name for s in drained.spans]
    assert names.count("api.masked_stretch_composite") == 1
    root = next(s for s in drained.spans
                if s.name == "api.masked_stretch_composite")
    for name in ("stretch.masked.mask", "stretch.masked.mtf",
                 "stretch.masked.preview"):
        (span,) = [s for s in drained.spans if s.name == name]
        assert span.parent == root.id and span.request == root.request
    counters = drained.counters
    assert counters["stretch.masked.stars"] == got["stars_masked"] > 0
    assert counters["stretch.masked.candidates"] >= got["stars_masked"]
    assert counters["stretch.masked.iterations"] == sum(
        ch["iterations_run"] for ch in got["channels"].values())
    assert counters["stretch.masked.loops"] == 3
    # every loop stopped on its test before the tenth iteration
    assert all(ch["iterations_run"] < 10 for ch in got["channels"].values())
    assert counters["stretch.masked.ran_out"] == 0


@pytest.mark.parametrize("iterations,ran_out", [(1, 1), (10, 0)])
def test_loop_counters_tell_a_loop_that_ran_out(iterations, ran_out):
    """``stretch.masked.ran_out`` counts a loop that used every iteration
    without stopping on its test; a loop that stops counts none."""
    from astroburst_tpu_torch.imaging.masked_stretch import \
        MaskedStretchConfig
    img = torch.from_numpy(_crowded(256, 224, 60, 31))
    trace.drain()
    trace.enable()
    try:
        got = masked_stretch(img, MaskedStretchConfig(iterations=iterations),
                             device=CPU)
        counters = trace.drain().counters
    finally:
        trace.disable()
    assert counters["stretch.masked.loops"] == 1
    assert counters["stretch.masked.iterations"] == got.iterations_run
    assert counters["stretch.masked.ran_out"] == ran_out
    assert (got.iterations_run < iterations) == (ran_out == 0)
