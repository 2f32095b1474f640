"""PyTorch port: the phase correlation's CUDA graphs
(``alignment/phase_correlation.py``: ``hann_on``, ``graph_key``,
``GraphCache``, ``_StackGraphs``).

On the CPU: the device windows are ``hann_periodic`` bit for bit; a CPU
stack runs eagerly, counts nothing and gives the bits it gave before
the graphs existed (``GOLDEN``, recorded from the eager code at these
seeds); the cache's keys and its LRU bound, driven by a stand-in
``build``; and ``_StackGraphs`` itself, driven by a stand-in capture that
replays by running the body again into the first run's tensors, bit
for bit against the eager call, after the stack changes in place and
with another stack of the same shape.

Marked ``card`` (skip without a CUDA card; this file imports no JAX,
so on the card it runs with ``--noconftest``): the captured graphs
against the eager call at the two benchmark shapes, and
``align_stack_stretch`` in ``kernels.plain_versions()``: no launch of
K1, K2 or K3, and the bits of a run that calls their plain versions by
name.
"""

import contextlib

import numpy as np
import pytest
import torch

from astroburst_tpu_torch.alignment import phase_correlation as pc
from astroburst_tpu_torch.ops.window import hann_periodic
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace

CPU = torch.device("cpu")
GRAPH_COUNTERS = ("alignment.phase_corr.graph_replay",
                  "alignment.phase_corr.graph_capture",
                  "alignment.phase_corr.eager")


def _star_field(rng, h, w, n_stars=12, sigma2=8.0):
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sy, sx in zip(rng.uniform(20, h - 20, n_stars),
                      rng.uniform(20, w - 20, n_stars)):
        base += 900.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / sigma2)
    return base.astype(np.float32)


def _scene(n, h, w, seed):
    """[n, h, w]: frame 0 the reference, the others rolled by whole
    pixels with their own noise; a NaN patch in frame 1 and a constant
    last frame (the validity gate zeroes it)."""
    rng = np.random.default_rng(seed)
    base = _star_field(rng, h, w)
    shifts = rng.integers(-9, 10, (n, 2))
    shifts[0] = 0
    frames = np.stack([np.roll(base, tuple(s), (0, 1))
                       + rng.normal(0, 1, (h, w)).astype(np.float32)
                       for s in shifts]).astype(np.float32)
    frames[1, 10:20, 30:40] = np.nan
    frames[-1] = 7.0
    return torch.from_numpy(frames)


# (n, h, w) at seed 2025 -> the uint32 bits of (dys, dxs, confidences),
# as the eager code gave them before the graphs
GOLDEN = {
    (5, 600, 700): (
        [0x400002fa, 0x4000016e, 0xc0fffc2d, 0x0],
        [0x410005a8, 0x3f801fc0, 0x40401580, 0x0],
        [0x438c7339, 0x438510df, 0x438752ed, 0x0]),
    (4, 200, 300): (
        [0xc0dffafc, 0x40a004e4, 0x0],
        [0x40e0092a, 0x410ff765, 0x0],
        [0x43979fdc, 0x43990b54, 0x0]),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


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


# ---- the device windows ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 441, 471, 512])
def test_hann_on_is_hann_periodic(n):
    w = pc.hann_on(n, CPU)
    assert w.dtype == torch.float32 and w.device == CPU
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  hann_periodic(n).view(np.uint32))
    assert pc.hann_on(n, CPU) is w        # made once per (length, device)


# ---- a CPU stack runs eagerly, as before -------------------------------------


@pytest.mark.parametrize("shape", sorted(GOLDEN))
def test_cpu_stack_is_eager_and_unchanged(shape, tracing):
    stack = _scene(*shape, 2025)
    keys = pc._GRAPHS.keys()
    for _ in range(3):      # a repeated shape is still eager on the CPU
        got = pc.phase_correlate_stack(stack[0], stack[1:])
        for g, want in zip(got, GOLDEN[shape]):
            np.testing.assert_array_equal(_bits(g),
                                          np.array(want, np.uint32))
    counters = trace.drain().counters
    assert not any(c in counters for c in GRAPH_COUNTERS), counters
    assert pc._GRAPHS.keys() == keys


# ---- the cache's keys and its bound ------------------------------------------


class _Built:
    def __init__(self, key):
        self.key = key


def test_cache_first_eager_second_builds_third_reuses():
    built = []

    def build(key):
        built.append(key)
        return _Built(key)
    cache = pc.GraphCache(build)
    assert cache.get("a") is None                 # first sighting: eager
    assert built == []
    entry = cache.get("a")                        # second: captured
    assert isinstance(entry, _Built) and built == ["a"]
    assert cache.get("a") is entry                # third: replayed
    assert built == ["a"]


def test_cache_holds_at_most_four_keys_lru():
    cache = pc.GraphCache(_Built)
    for k in "abcd":
        cache.get(k)
        cache.get(k)
    assert cache.keys() == list("abcd")
    cache.get("a")                                # a: most recent
    assert cache.get("e") is None                 # drops b, the oldest
    assert cache.keys() == list("cdae")
    assert cache.get("b") is None                 # seen anew: eager again
    assert len(cache.keys()) == 4
    entry = cache.get("e")
    assert isinstance(entry, _Built) and cache.get("e") is entry


def test_graph_key_names_device_shape_dtype():
    stack = torch.zeros((4, 600, 700))
    assert pc.graph_key(stack[0], stack[1:]) == (CPU, 3, 600, 700,
                                                 torch.float32)
    f64 = stack.double()
    assert pc.graph_key(f64[0], f64[1:]) == (CPU, 3, 600, 700,
                                             torch.float64)
    assert pc.graph_key(stack[0], stack[1:2]) != pc.graph_key(stack[0],
                                                               stack[1:])
    # no key: no target, a reference of another shape, device or dtype,
    # a strided view
    assert pc.graph_key(stack[0], stack[:0]) is None
    assert pc.graph_key(stack[0, :599], stack[1:]) is None
    assert pc.graph_key(stack[0].to("meta"), stack[1:]) is None
    assert pc.graph_key(f64[0], stack[1:]) is None
    assert pc.graph_key(stack[0], stack[1:, :, ::2]) is None


class _Asked(Exception):
    pass


def test_only_cuda_non_plain_large_calls_reach_the_cache(monkeypatch,
                                                         tracing):
    """The route, with ``is_cuda`` faked on CPU tensors: calls in
    ``kernels.plain_versions()`` and planes of at most 512 px never ask
    the cache (the small one counts as eager), a large call outside it
    asks it with its key; on real CPU tensors no call asks."""
    asked = []

    class Cache:
        def get(self, key):
            asked.append(key)
            raise _Asked
    monkeypatch.setattr(pc, "_GRAPHS", Cache())
    large, small = _scene(5, 600, 700, 2025), _scene(4, 200, 300, 2025)
    for stack in (large, small):
        pc.phase_correlate_stack(stack[0], stack[1:])
        with K.plain_versions():
            pc.phase_correlate_stack(stack[0], stack[1:])
    assert asked == [] and trace.drain().counters == {}

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with K.plain_versions():
        pc.phase_correlate_stack(large[0], large[1:])
        pc.phase_correlate_stack(small[0], small[1:])
    assert asked == [] and trace.drain().counters == {}
    pc.phase_correlate_stack(small[0], small[1:])
    assert asked == []
    assert trace.drain().counters == {"alignment.phase_corr.eager": 1}
    with pytest.raises(_Asked):
        pc.phase_correlate_stack(large[0], large[1:])
    assert asked == [(CPU, 4, 600, 700, torch.float32)]


# ---- _StackGraphs, through a stand-in capture --------------------------------


class _Replayed:
    """A CUDA graph's contract on the CPU: the outputs of the first run
    are the graph's tensors, and each replay writes its results into
    them."""

    def __init__(self, body):
        self.body = body
        self.out = body()

    def replay(self):
        new = self.body()
        if isinstance(self.out, torch.Tensor):
            self.out.copy_(new)
        else:
            for o, n in zip(self.out, new):
                o.copy_(n)

    def pool(self):
        return None


def _stand_in_capture(body, pool=None):
    graph = _Replayed(body)
    return graph, graph.out


def _eager(ref, targets):
    with _cache(pc.GraphCache(pc._StackGraphs, capacity=0)):
        return pc.phase_correlate_stack(ref, targets)


@contextlib.contextmanager
def _cache(cache):
    was = pc._GRAPHS
    pc._GRAPHS = cache
    try:
        yield
    finally:
        pc._GRAPHS = was


def test_stack_graphs_data_flow_matches_eager_on_the_cpu():
    stack = _scene(5, 600, 700, 2025)
    key = pc.graph_key(stack[0], stack[1:])
    graphs = pc._StackGraphs(key, capture=_stand_in_capture)
    first = graphs.run(stack[0], stack[1:])           # the capture
    _assert_bit_equal(first, _eager(stack[0], stack[1:]))
    for g, want in zip(first, GOLDEN[(5, 600, 700)]):
        np.testing.assert_array_equal(_bits(g), np.array(want, np.uint32))
    again = graphs.run(stack[0], stack[1:])           # a replay
    _assert_bit_equal(again, first)
    assert again[0].data_ptr() != first[0].data_ptr()  # the caller's own

    # the stack's values change in place: the replay follows them
    stack[1:4] = torch.roll(stack[1:4], (3, -5), (1, 2)).clone()
    moved = graphs.run(stack[0], stack[1:])
    _assert_bit_equal(moved, _eager(stack[0], stack[1:]))
    assert not torch.equal(moved[0][:3], first[0][:3])
    _assert_bit_equal(first, again)                    # the clones kept

    # another stack of the same shape, at another address
    other = _scene(5, 600, 700, 77)
    got = graphs.run(other[0], other[1:])
    _assert_bit_equal(got, _eager(other[0], other[1:]))


def test_stack_graphs_k1_k2_fill_their_buffers_in_place():
    stack = _scene(3, 640, 520, 5)
    graphs = pc._StackGraphs(pc.graph_key(stack[0], stack[1:]),
                             capture=_stand_in_capture)
    bufs = [t.data_ptr() for t in (*graphs.ref_k1, *graphs.tgt_k1,
                                   graphs.crops, graphs.ref_crop)]
    for seed in (5, 6):
        s = _scene(3, 640, 520, seed)
        _assert_bit_equal(graphs.run(s[0], s[1:]), _eager(s[0], s[1:]))
    assert bufs == [t.data_ptr() for t in (*graphs.ref_k1, *graphs.tgt_k1,
                                           graphs.crops, graphs.ref_crop)]
    assert graphs.crops.shape == (2, 512, 512)
    assert graphs.ref_k1[0].shape == (1, 320, 260)     # box 2 x 2


def test_k1_k2_out_buffers_match_their_returns():
    from astroburst_tpu_torch.alignment.coarse_kernel import (
        coarse_downsample_stack, reduce_row_stats)
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops
    stack = _scene(3, 600, 700, 3)
    ds, by, bx, mn, mx, cnt = coarse_downsample_stack(stack, 512,
                                                      with_stats=True)
    out = (torch.empty_like(ds), torch.empty((3, ds.shape[1])),
           torch.empty((3, ds.shape[1])),
           torch.empty((3, ds.shape[1]), dtype=torch.int32))
    got = coarse_downsample_stack(stack, 512, out=out)
    assert got[0] is out[0] and got[1:3] == (by, bx)
    _assert_bit_equal([got[0]], [ds])
    _assert_bit_equal(reduce_row_stats(*got[3:]), (mn, mx, cnt))
    with pytest.raises(ValueError, match="out buffers"):
        coarse_downsample_stack(stack, 512, out=(out[0][:2], *out[1:]))
    origins = torch.tensor([0, 40]), torch.tensor([128, 0])
    crops = gather_crops(stack, *origins, 512, 512)
    buf = torch.empty_like(crops)
    assert gather_crops(stack, *origins, 512, 512, out=buf) is buf
    _assert_bit_equal([buf], [crops])
    with pytest.raises(ValueError, match="out must be"):
        gather_crops(stack, *origins, 512, 512, out=buf[:, :, :500])


# ---- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_stack(n, h, w, seed, dev):
    """[n, h, w] on the card: a star field rolled by whole pixels, with
    noise of its own a frame."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 100.0 + 3.0 * torch.randn((h, w), device=dev, generator=g)
    pos = torch.rand((40, 2), device=dev, generator=g) * torch.tensor(
        [h - 40.0, w - 40.0], device=dev) + 20.0
    for sy, sx in pos.tolist():
        y0, x0 = int(sy) - 12, int(sx) - 12
        sub = (slice(y0, y0 + 25), slice(x0, x0 + 25))
        base[sub] += 900.0 * torch.exp(-((yy[sub[0]] - sy) ** 2
                                         + (xx[:, sub[1]] - sx) ** 2) / 8.0)
    shifts = torch.randint(-12, 13, (n, 2), device=dev, generator=g)
    shifts[0] = 0
    return torch.stack([torch.roll(base, tuple(s), (0, 1))
                        + torch.randn((h, w), device=dev, generator=g)
                        for s in shifts.tolist()])


@pytest.mark.card
@pytest.mark.parametrize("shape", [(16, 5655, 2206), (10, 4096, 4096)])
def test_card_replay_is_bit_equal_to_eager(shape, tracing):
    dev = _card()
    stack = _card_stack(*shape, 2025, dev)
    with _cache(pc.GraphCache(pc._StackGraphs)):
        eager = _eager(stack[0], stack[1:])
        first = pc.phase_correlate_stack(stack[0], stack[1:])   # eager
        _assert_bit_equal(first, eager)
        captured = pc.phase_correlate_stack(stack[0], stack[1:])
        _assert_bit_equal(captured, eager)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            replayed = pc.phase_correlate_stack(stack[0], stack[1:])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _assert_bit_equal(replayed, eager)

        stack[1:] = torch.roll(stack[1:], (5, -7), (1, 2)).clone()
        moved = pc.phase_correlate_stack(stack[0], stack[1:])
        _assert_bit_equal(moved, _eager(stack[0], stack[1:]))
        assert not torch.equal(moved[0], eager[0])

        other = _card_stack(*shape, 99, dev)
        assert other.data_ptr() != stack.data_ptr()
        _assert_bit_equal(pc.phase_correlate_stack(other[0], other[1:]),
                          _eager(other[0], other[1:]))
    counters = trace.drain().counters
    # eager x 4 (the reference calls and the first sighting), one capture,
    # replays on the capture call and the four after it
    assert counters["alignment.phase_corr.graph_capture"] == 1
    assert counters["alignment.phase_corr.graph_replay"] == 4
    assert counters["alignment.phase_corr.eager"] == 4


@pytest.mark.card
def test_card_plain_versions_launch_no_kernel(monkeypatch):
    """On the card ``align_stack_stretch`` in ``plain_versions()`` adds
    nothing to K1's, K2's or K3's launches and gives the bits of the
    run that names their plain versions (eager: the graphs never
    replay)."""
    from astroburst_tpu_torch.alignment.coarse_kernel import (
        coarse_downsample_stack_plain)
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops_plain
    from astroburst_tpu_torch.parallel import pipeline
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        shift_clip_onepass_plain)
    dev = _card()
    stack = _card_stack(8, 2206, 1400, 2025, dev)
    kernels = (pc.coarse_downsample_stack, pc.gather_crops,
               pipeline.shift_clip_onepass)
    before = [k.launches for k in kernels]
    with K.plain_versions():
        got = pipeline.align_stack_stretch(stack)
        got = pipeline.align_stack_stretch(stack)   # a key seen before
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    with _cache(pc.GraphCache(pc._StackGraphs, capacity=0)):
        monkeypatch.setattr(pc, "coarse_downsample_stack",
                            coarse_downsample_stack_plain)
        monkeypatch.setattr(pc, "gather_crops", gather_crops_plain)
        monkeypatch.setattr(pipeline, "shift_clip_onepass",
                            shift_clip_onepass_plain)
        want = pipeline.align_stack_stretch(stack)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           want[k].reshape(-1).view(torch.uint8)), k
