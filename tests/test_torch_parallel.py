"""PyTorch port: the multi-device layer (``astroburst_tpu_torch.parallel``)
against the port's single-device functions and the JAX package.

The port's mesh is 8 CPU shards in this process (``make_mesh([cpu] * 8,
...)``), the JAX package's the conftest's 8 virtual CPU devices
(``make_mesh(8, ("frames", "rows"), (4, 2))``); the same numpy-seeded
inputs go to both. On the CPU every kernel wrapper runs its plain
version; the card holds the kernels to them (chip_smoke.py phase 4m).

Bit-equal to the port's single device: K3's slab entry stitched over
the shards (offsets past ±16 too), the sharded step's combined,
preview, offsets, stf and rejected count (``align_stack_stretch``),
the drizzle (``_drizzle_kernel_exact``), the warp (``warp_image``), the
à trous smooth, the sharded stats (``stats_core``), the cube median (a
numpy rank), the compose on 8 shards against the compose on one.

Held to the JAX package within the tolerances these paths carry:
- K3 against JAX's one-pass kernel and its slab entry in interpret
  mode: ≤ 3 pixels off by more than 5e-3, rejected counts within 3
  (tests/test_torch_sigma_clip.py: tap sums in another order);
- offsets 0.05 px (``jax_parabola_vertex``, ROADMAP C8); STF parameters
  1e-4 and the stats' median and MAD within 2·range/8⁶ (C5, C21: JAX's
  compare-count ranks);
- the FFT within 3e-6 of the largest magnitude (JAX's four-step matmul
  against pocketfft); RL within 5e-5 of the largest value (C30); the
  spectrum atol 2e-3 (tests/test_parallel.py);
- the cube median within 2·range/8⁶ of JAX's (C31); the mean within 1e-5;
- drizzle: image atol 2e-4 / rtol 1e-6, weights atol 1e-5, rejected
  equal (tests/test_torch_drizzle.py);
- the warp: atol 1e-4 on a plane scaled to a peak of 1 against JAX's
  direct sampler (tests/test_torch_affine.py; JAX's sharded warp is its
  shear warp, which the port does not carry);
- compose: planes atol 2e-5 and STF parameters 1e-5 against
  ``process_rgb`` (tests/test_parallel_compose.py), and against JAX's
  sharded compose.
The sharded cube mean adds the shards' sums in another order than the
single device's ``torch.sum``: within 1e-5 of it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from astroburst_tpu.alignment import affine as ja
from astroburst_tpu.analysis.deconvolution import (
    generate_gaussian_psf as jpsf, richardson_lucy as jrl)
from astroburst_tpu.analysis.fft import _spectrum_kernel as jspectrum
from astroburst_tpu.dtypes import DrizzleKernel as JDK
from astroburst_tpu.dtypes import RLConfig as JRL
from astroburst_tpu.imaging.wavelet import atrous_smooth as jatrous
from astroburst_tpu.ops.stats import stats_core as jstats
from astroburst_tpu.parallel import make_mesh as jmesh
from astroburst_tpu.parallel.compose import make_sharded_compose as jcompose
from astroburst_tpu.parallel.cube import (shard_cube as jshard_cube,
                                          sharded_collapse_mean as jmean,
                                          sharded_collapse_median as jmedian)
from astroburst_tpu.parallel.drizzle import sharded_drizzle as jdrizzle
from astroburst_tpu.parallel.fft import sharded_fft2 as jfft2
from astroburst_tpu.parallel.pipeline import (
    align_stack_stretch as jpipeline, reshard_frames_to_rows as jreshard)
from astroburst_tpu.stacking.onepass_kernel import (
    shift_clip_onepass as jk3, shift_clip_onepass_slab as jk3_slab)
from astroburst_tpu_torch import parallel as tp
from astroburst_tpu_torch.alignment.affine import (AffineTransform,
                                                    warp_image)
from astroburst_tpu_torch.analysis.deconvolution import richardson_lucy
from astroburst_tpu_torch.analysis.fft import _spectrum
from astroburst_tpu_torch.compose.channel_blend import (blend_channels,
                                                        blend_weights)
from astroburst_tpu_torch.compose.rgb import process_rgb
from astroburst_tpu_torch.cube.eager import collapse_mean
from astroburst_tpu_torch.dtypes import (DrizzleKernel, RgbComposeConfig,
                                         RLConfig, WhiteBalance,
                                         WhiteBalanceMode)
from astroburst_tpu_torch.imaging.wavelet import atrous_smooth
from astroburst_tpu_torch.ops.stats import stats_core
from astroburst_tpu_torch.parallel.compose import make_sharded_compose
from astroburst_tpu_torch.parallel.cube import (shard_cube,
                                                sharded_collapse_mean,
                                                sharded_collapse_median)
from astroburst_tpu_torch.parallel.drizzle import sharded_drizzle
from astroburst_tpu_torch.parallel.fft import (sharded_deconvolve,
                                               sharded_fft2, sharded_ifft2,
                                               sharded_power_spectrum)
from astroburst_tpu_torch.parallel.halo import (exchange_row_halos,
                                                sharded_atrous_smooth,
                                                sharded_stencil_map)
from astroburst_tpu_torch.parallel.mesh import Sharded, make_mesh, shard
from astroburst_tpu_torch.parallel.pipeline import (
    align_stack_stretch, make_sharded_stack_step, reshard_frames_to_rows,
    sharded_shift_clip, sharded_shift_clip_a2a, sharded_stats_core)
from astroburst_tpu_torch.parallel.warp import make_sharded_warp
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.stacking.drizzle import _drizzle_kernel_exact
from astroburst_tpu_torch.stacking.onepass_kernel import (
    shift_clip_onepass, shift_clip_onepass_slab, slab_halo)
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(shape, axes):
    return make_mesh([CPU] * int(np.prod(shape)), axes, shape)


def _flips(got, want, got_rej, want_rej, max_flips=3):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flips = int((d > 5e-3).sum())
    assert flips <= max_flips, f"{flips} pixels differ, max |d|={d.max()}"
    assert abs(int(got_rej) - int(want_rej)) <= max_flips


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32) if a.dtype == torch.float32
        else a, b.contiguous().view(torch.int32)
        if b.dtype == torch.float32 else b)


def _star_frames(rng, n, h, w, shifts):
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sy, sx in ((h * 0.5, w * 0.5), (h * 0.25, w * 0.7),
                   (h * 0.75, w * 0.3)):
        base += 500.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 8.0)
    frames = [np.roll(base, tuple(s), axis=(0, 1)) +
              rng.normal(0, 1, (h, w)).astype(np.float32) for s in shifts]
    return np.stack(frames).astype(np.float32)


SHIFTS = [(0, 0), (2, -1), (-1, 3), (3, 2), (-2, -2), (1, 0), (0, -3),
          (-3, 1)]


@pytest.fixture(scope="module")
def step_frames():
    return _star_frames(np.random.default_rng(1234), 8, 128, 64, SHIFTS)


@pytest.fixture(scope="module")
def jax_step_single(step_frames):
    out = jax.jit(lambda s: jpipeline(s, max_iter=2, use_pallas=False))(
        jnp.asarray(step_frames))
    return {k: np.asarray(v) for k, v in out.items()}


# ---- the mesh ------------------------------------------------------------


def test_mesh_of_eight_cpu_shards_beside_jax_devices():
    assert len(jax.devices()) == 8
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    assert mesh.shape == {"frames": 4, "rows": 2} and mesh.size == 8
    assert [mesh.index(i, ("frames", "rows")) for i in range(8)] == list(
        range(8))
    assert mesh.groups("rows") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups("frames") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    flat = make_mesh([CPU] * 3, ("frames", "rows"))
    assert flat.shape == {"frames": 3, "rows": 1}


def test_mesh_without_devices_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"devices": 4}, {"shape": (2, 2)}):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh(**kw)


def test_collectives_copy_on_a_repeated_device_and_count():
    mesh = cpu_mesh((4,), ("rows",))
    xs = [torch.full((2, 4), float(i)) for i in range(4)]
    got = mesh.ppermute(xs, "rows", [(0, 1), (1, 2)])
    assert got[0] is None and got[3] is None
    got[1][0, 0] = 99.0      # a copy: the sender's tensor is untouched
    assert float(xs[0][0, 0]) == 0.0
    assert mesh.moved["ppermute"] == 16 and mesh.calls["ppermute"] == 1
    a2a = mesh.all_to_all(xs, "rows", split_dim=1, concat_dim=0)
    for j, y in enumerate(a2a):
        assert y.shape == (8, 1)
        assert y[:, 0].tolist() == [float(i) for i in range(4)
                                    for _ in range(2)]
    assert mesh.moved["all_to_all"] == 4 * 3 * 2
    tot = mesh.psum(xs, "rows")
    assert all(float(t[0, 0]) == 6.0 for t in tot)
    tot[0][0, 0] = -1.0
    assert float(tot[1][0, 0]) == 6.0
    assert [float(t.min()) for t in mesh.pmin(xs, "rows")] == [0.0] * 4
    assert [float(t.max()) for t in mesh.pmax(xs, "rows")] == [3.0] * 4
    b = mesh.broadcast(xs[2])
    assert all(t is not xs[2] and torch.equal(t, xs[2]) for t in b)
    assert mesh.moved["broadcast"] == 8 * 4
    mesh.reset_counts()
    assert not mesh.moved and not mesh.calls


def test_sharded_full_crops_the_padded_blocks():
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    s = shard(mesh, x, 0, ("frames", "rows"), pad_edge=True)
    assert all(p.shape == (2, 3) for p in s.parts)
    assert torch.equal(s.parts[-1], x[[9, 9]])
    assert torch.equal(s.full(), x)
    r = shard(mesh, x, 0, "frames")
    assert torch.equal(r.parts[0], r.parts[1]) and r.parts[0] is not \
        r.parts[1]
    assert torch.equal(r.full(), x)


# ---- the sharded step ----------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((4, 2), ("frames", "rows")),
                                        ((2, 4), ("frames", "rows")),
                                        ((8,), ("frames",))])
def test_sharded_stack_step_matches_single_device(step_frames,
                                                  jax_step_single, shape,
                                                  axes):
    stack = torch.from_numpy(step_frames)
    single = align_stack_stretch(stack, max_iter=2)
    out = make_sharded_stack_step(cpu_mesh(shape, axes), max_iter=2)(stack)
    assert isinstance(out["combined"], Sharded)
    assert _equal(out["combined"].full(), single["combined"])
    assert torch.equal(out["preview"].full(), single["preview"])
    for k in ("offsets", "stf", "rejected"):
        assert torch.equal(out[k], single[k]), k
    np.testing.assert_allclose(out["confidences"].numpy(),
                               single["confidences"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(out["offsets"].numpy(),
                               jax_step_single["offsets"], atol=0.05)
    np.testing.assert_allclose(out["offsets"][1:].numpy(),
                               np.float32(SHIFTS[1:]), atol=0.1)
    _flips(out["combined"].full().numpy(), jax_step_single["combined"],
           out["rejected"], jax_step_single["rejected"])
    np.testing.assert_allclose(out["stf"].numpy(), jax_step_single["stf"],
                               atol=1e-4)


def test_sharded_step_uneven_rows_matches_single_device():
    """90 rows over 8 row shards: the blocks are padded with edge rows
    past the image (12 a shard), as the JAX package pads."""
    frames = _star_frames(np.random.default_rng(7), 8, 90, 64, SHIFTS)
    stack = torch.from_numpy(frames)
    single = align_stack_stretch(stack, max_iter=2)
    for shape in ((4, 2), (8,)):
        axes = ("frames", "rows")[:len(shape)]
        out = make_sharded_stack_step(cpu_mesh(shape, axes),
                                      max_iter=2)(stack)
        assert _equal(out["combined"].full(), single["combined"]), shape
        assert torch.equal(out["preview"].full(), single["preview"])
        assert int(out["rejected"]) == int(single["rejected"])


def test_sharded_step_on_cpu_runs_the_plain_versions(step_frames):
    before = shift_clip_onepass_slab.launches
    stack = torch.from_numpy(step_frames[:4])
    mesh = cpu_mesh((2, 2), ("frames", "rows"))
    a = make_sharded_stack_step(mesh, max_iter=3)(stack)
    with K.plain_versions():
        b = make_sharded_stack_step(mesh, max_iter=3)(stack)
    assert shift_clip_onepass_slab.launches == before
    assert _equal(a["combined"].full(), b["combined"].full())
    placed = shard(mesh, stack, 0, "frames")
    c = make_sharded_stack_step(mesh, max_iter=3)(placed)
    assert _equal(a["combined"].full(), c["combined"].full())


# ---- K3's slab entry and the sharded shift + clip --------------------------


def _clip_inputs(rng, n, h, w, off):
    s = rng.normal(100, 3, (n, h, w)).astype(np.float32)
    s[rng.random(s.shape) < 0.01] = np.nan
    s[2, h // 2, w // 2] = 5000.0
    dys = rng.uniform(-off, off, n).astype(np.float32)
    dxs = rng.uniform(-off, off, n).astype(np.float32)
    dys[0] = dxs[0] = 0.0
    return s, dys, dxs


@pytest.mark.parametrize("shape,axes", [((4, 2), ("frames", "rows")),
                                        ((8,), ("rows",))])
def test_sharded_shift_clip_matches_single_device(rng, shape, axes):
    """The rows split over both axes, or over the one rows axis; the
    single device's K3 is held to JAX's in tests/test_torch_sigma_clip.py
    and the a2a route below to JAX's kernel directly."""
    s, dys, dxs = _clip_inputs(rng, 6, 96, 64, 7.0)
    stack = torch.from_numpy(s)
    want, wrej = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 3)
    got, rej = sharded_shift_clip(cpu_mesh(shape, axes), stack, dys, dxs,
                                  axes, 3.0, 3.0, 3)
    assert _equal(got.full(), want) and int(rej) == int(wrej)


@pytest.mark.parametrize("h", [96, 90])
def test_sharded_a2a_clip_matches_plain(rng, h):
    """The a2a route and the rows route equal the single device, also
    where 90 rows do not split evenly (edge rows pad the blocks); at 96
    rows both are held to JAX's one-pass kernel."""
    s, dys, dxs = _clip_inputs(rng, 8, h, 64, 3.0)
    stack = torch.from_numpy(s)
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    want, wrej = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 2)
    got, rej = sharded_shift_clip_a2a(mesh, stack, dys, dxs, "frames",
                                      "rows", 3.0, 3.0, 2)
    rows, rrej = sharded_shift_clip(mesh, stack, dys, dxs,
                                    ("frames", "rows"), 3.0, 3.0, 2)
    assert _equal(got.full(), want) and _equal(rows.full(), want)
    assert int(rej) == int(rrej) == int(wrej)
    assert mesh.calls["all_to_all"] == 1
    if h == 96:     # JAX's interpret mode takes seconds: once
        jc, jr = jk3(jnp.asarray(s), jnp.asarray(dys), jnp.asarray(dxs),
                     3.0, 3.0, 2, off_max=4, interpret=True)
        _flips(got.full().numpy(), np.asarray(jc), rej, jr)


def test_sharded_a2a_clip_needs_whole_frame_blocks(rng):
    s, dys, dxs = _clip_inputs(rng, 6, 64, 32, 2.0)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_shift_clip_a2a(cpu_mesh((4, 2), ("frames", "rows")),
                               torch.from_numpy(s), dys, dxs, "frames",
                               "rows", 3.0, 3.0, 2)


def test_onepass_slab_mode_directly(rng):
    """The slab entry with hand-built halos equals the whole-stack K3 on
    the band (the out_off / grow0 / gh coordinate math), and JAX's slab
    entry in interpret mode."""
    n, h, w = 4, 64, 64
    halo = 10
    s = rng.normal(100, 3, (n, h, w)).astype(np.float32)
    dys = np.float32([0.0, 2.5, -3.0, 1.25])
    dxs = np.float32([0.0, -1.5, 4.0, -2.25])
    full, _ = shift_clip_onepass(torch.from_numpy(s), dys, dxs, 3.0, 3.0, 3)
    r0, r1 = 24, 40
    slab = torch.from_numpy(s[:, r0 - halo:r1 + halo].copy())
    got, rej = shift_clip_onepass_slab(slab, dys, dxs, halo, r0, h, 3.0,
                                       3.0, 3)
    assert _equal(got, full[r0:r1])
    want, wrej = jk3_slab(jnp.asarray(s[:, r0 - halo:r1 + halo]),
                          jnp.asarray(dys), jnp.asarray(dxs), halo,
                          jnp.int32(r0), h, 3.0, 3.0, 3, off_max=8,
                          interpret=True)
    _flips(got.numpy(), np.asarray(want), rej, wrej)


@pytest.mark.parametrize("r0,r1", [(0, 24), (40, 80), (96, 120)])
def test_slab_entry_past_the_tpu_clamp(rng, r0, r1):
    """Offsets up to ±40 (past JAX's ±16 clamp, C7): the halo is
    ceil(max |dy|) + 2 and the slab, edge rows repeated past the image,
    equals the whole-stack K3 on its rows."""
    s, dys, dxs = _clip_inputs(rng, 5, 120, 48, 40.0)
    halo = slab_halo(dys)
    assert halo == math.ceil(float(np.abs(dys).max())) + 2
    full, _ = shift_clip_onepass(torch.from_numpy(s), dys, dxs, 2.5, 3.0, 5)
    idx = np.clip(np.arange(r0 - halo, r1 + halo), 0, 119)
    got, _ = shift_clip_onepass_slab(torch.from_numpy(s[:, idx].copy()),
                                     dys, dxs, halo, r0, 120, 2.5, 3.0, 5)
    assert _equal(got, full[r0:r1])


def test_slab_entry_refuses_a_short_halo(rng):
    s, dys, dxs = _clip_inputs(rng, 3, 40, 32, 9.0)
    need = slab_halo(dys)
    with pytest.raises(ValueError, match="halo"):
        shift_clip_onepass_slab(torch.from_numpy(s), dys, dxs, need - 1, 0,
                                40)


def test_reshard_frames_to_rows_all_to_all(rng):
    """One all_to_all over the frames axis: shard (f, r) ends with every
    frame of row block f·R + r; the layout equals JAX's."""
    x = rng.normal(size=(8, 64, 32)).astype(np.float32)
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    out = reshard_frames_to_rows(mesh, torch.from_numpy(x), "frames",
                                 "rows")
    assert out.dim == 1 and all(p.shape == (8, 8, 32) for p in out.parts)
    assert torch.equal(out.full(), torch.from_numpy(x))
    assert mesh.calls == {"all_to_all": 1}
    jm = jmesh(8, ("frames", "rows"), (4, 2))
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(jm, P("frames", None, None)))
    want = jax.jit(lambda a: jreshard(jm, a, "frames", "rows"))(xd)
    for i, part in enumerate(out.parts):
        np.testing.assert_array_equal(part.numpy(),
                                      x[:, 8 * i:8 * (i + 1)])
    np.testing.assert_array_equal(np.asarray(want), out.full().numpy())


# ---- halos and stencils --------------------------------------------------


def test_exchange_row_halos_repeats_the_edges(rng):
    x = torch.from_numpy(rng.random((16, 5)).astype(np.float32))
    mesh = cpu_mesh((4,), ("rows",))
    ext = exchange_row_halos(mesh, shard(mesh, x, 0, "rows").parts, 2,
                             "rows")
    idx = np.clip(np.arange(-2, 18), 0, 15)
    for g, e in enumerate(ext):
        assert torch.equal(e, x[idx[4 * g:4 * g + 8]])
    with pytest.raises(ValueError, match="halo"):
        exchange_row_halos(mesh, shard(mesh, x, 0, "rows").parts, 5, "rows")


def test_sharded_stencil_map_halo_identity(rng):
    x = torch.from_numpy(rng.random((64, 32)).astype(np.float32))
    mesh = cpu_mesh((4,), ("rows",))
    got = sharded_stencil_map(x, mesh, "rows", lambda e, h: e[h:-h], 2)
    assert torch.equal(got.full(), x)


@pytest.mark.parametrize("step", [1, 2, 4])
def test_sharded_atrous_matches_local(rng, step):
    x = rng.random((256, 96)).astype(np.float32)
    mesh = cpu_mesh((8,), ("rows",))
    got = sharded_atrous_smooth(torch.from_numpy(x), mesh, "rows", step)
    assert _equal(got.full(), atrous_smooth(torch.from_numpy(x), step))
    np.testing.assert_allclose(got.full().numpy(),
                               np.asarray(jatrous(jnp.asarray(x), step)),
                               atol=1e-5)


def test_sharded_atrous_uneven_rows(rng):
    x = torch.from_numpy(rng.random((90, 40)).astype(np.float32))
    got = sharded_atrous_smooth(x, cpu_mesh((8,), ("rows",)), "rows", 2)
    assert _equal(got.full(), atrous_smooth(x, 2))


# ---- the sharded stats ---------------------------------------------------


@pytest.mark.parametrize("exact_pair", [False, True])
def test_sharded_stats_reduce_over_shards(rng, exact_pair):
    """min, max, count, median and MAD over a row-sharded plane equal
    ``stats_core`` on the whole (the median and MAD exact by the key
    bisection), and JAX's within its compare-count tolerance."""
    x = rng.random((128, 64)).astype(np.float32) * 50.0 + 1.0
    x[:10] = 0.0
    x[20, 5] = np.nan
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    parts = shard(mesh, torch.from_numpy(x), 0, ("frames", "rows")).parts
    got = sharded_stats_core(mesh, parts, ("frames", "rows"), exact_pair)
    want = stats_core(torch.from_numpy(x), exact_pair)
    for k in (0, 1, 3, 4, 5):
        assert all(torch.equal(g, want[k]) for g in got[k]), k
    np.testing.assert_allclose(float(got[2][0]), float(want[2]), rtol=1e-6)
    jw = [float(v) for v in jstats(jnp.asarray(x), exact_pair)]
    rng_ = float(want[1] - want[0])
    for k in (0, 1, 3):
        assert float(got[k][0]) == jw[k]
    for k in (4, 5):
        assert abs(float(got[k][0]) - jw[k]) <= 2 * rng_ / 8 ** 6


# ---- warp ----------------------------------------------------------------


def _rotation(deg, cy, cx, ty=0.0, tx=0.0):
    th = math.radians(deg)
    ct, st = math.cos(th), math.sin(th)
    return (ct, -st, cx - ct * cx + st * cy + tx, st, ct,
            cy - st * cx - ct * cy + ty)


@pytest.mark.parametrize("hw,deg", [((96, 128), 3.0), ((90, 100), -2.0)])
def test_sharded_warp_matches_single_device(rng, hw, deg):
    h, w = hw
    img = rng.normal(100, 5, hw).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img += 300.0 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / 9.0)
    img /= img.max()
    t = AffineTransform(*_rotation(deg, h / 2, w / 2, 1.5, -0.75))
    mesh = cpu_mesh((8,), ("rows",))
    got = make_sharded_warp(mesh, t, h, w, "rows")(torch.from_numpy(img))
    assert _equal(got.full(), warp_image(torch.from_numpy(img), t, h, w))
    assert mesh.calls == {"broadcast": 1}
    want = np.asarray(ja.warp_image(img, ja.AffineTransform(*t.as_tuple()),
                                    h, w, exact=True))
    np.testing.assert_allclose(got.full().numpy(), want, atol=1e-4)


# ---- FFT, RL, spectrum -----------------------------------------------------


def test_sharded_fft2_matches_local(rng):
    x = rng.normal(size=(128, 256)).astype(np.float32)
    mesh = cpu_mesh((8,), ("rows",))
    xt = torch.from_numpy(x)
    gr, gi = sharded_fft2(mesh, xt, torch.zeros_like(xt))
    assert gr.dim == 1 and gr.parts[0].shape == (128, 32)
    ref = torch.fft.fft2(xt.to(torch.complex64))
    scale = float(ref.abs().max())
    np.testing.assert_allclose(gr.full().numpy(), ref.real.numpy(),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(gi.full().numpy(), ref.imag.numpy(),
                               atol=3e-6 * scale)
    jm = jmesh(8, ("rows",), (8,))
    jr, ji = jfft2(jm, jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    np.testing.assert_allclose(gr.full().numpy(), np.asarray(jr),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(gi.full().numpy(), np.asarray(ji),
                               atol=3e-6 * scale)
    br, bi = sharded_ifft2(mesh, gr, gi)
    np.testing.assert_allclose(br.full().numpy(), x, atol=1e-4)
    np.testing.assert_allclose(bi.full().numpy(), 0.0, atol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        sharded_fft2(mesh, xt[:100], torch.zeros_like(xt[:100]))


def test_sharded_deconvolve_matches_single(rng):
    img = rng.normal(50, 4, (96, 112)).astype(np.float32)
    img[40:43, 30:33] += 400.0
    img[60, 80] += 900.0
    psf = jpsf(11, 1.8)
    cfg = RLConfig(iterations=5, dering=True)
    ref = richardson_lucy(torch.from_numpy(img), psf, cfg)
    est, iters, conv = sharded_deconvolve(cpu_mesh((8,), ("rows",)),
                                          torch.from_numpy(img), psf, cfg)
    assert iters == ref.iterations_run == 5
    scale = float(ref.image.abs().max())
    np.testing.assert_allclose(est.full().numpy(), ref.image.numpy(),
                               atol=5e-5 * scale)
    assert conv == pytest.approx(ref.convergence, rel=1e-4)
    want = jrl(jnp.asarray(img), psf, JRL(iterations=5, dering=True))
    np.testing.assert_allclose(est.full().numpy(), np.asarray(want.image),
                               atol=5e-5 * scale)


def test_sharded_power_spectrum_matches_single(rng):
    img = rng.normal(10, 2, (200, 180)).astype(np.float32)
    img[13, 17] = np.nan
    got = sharded_power_spectrum(cpu_mesh((8,), ("rows",)),
                                 torch.from_numpy(img), True)
    assert got.dim == 0 and got.parts[0].shape == (32, 256)
    want = _spectrum(torch.from_numpy(img), 256, True)
    np.testing.assert_allclose(got.full().numpy(), want.numpy(),
                               atol=5e-5 * float(want.abs().max()))
    np.testing.assert_allclose(got.full().numpy(),
                               np.asarray(jspectrum(jnp.asarray(img), 256,
                                                    True)), atol=2e-3)


# ---- drizzle -------------------------------------------------------------


@pytest.mark.parametrize("kernel,out_rows,band", [
    (DrizzleKernel.SQUARE, 64, 8), (DrizzleKernel.SQUARE, 60, 8),
    (DrizzleKernel.GAUSSIAN, 64, 16), (DrizzleKernel.LANCZOS3, 60, 8)])
def test_sharded_drizzle_matches_single(rng, kernel, out_rows, band):
    frames = rng.normal(10, 1, (4, 32, 36)).astype(np.float32)
    frames[1, 8, 9] = 500.0
    stack = torch.from_numpy(frames)
    d_ys = np.float32([0.0, 0.35, -0.6, 0.15])
    d_xs = np.float32([0.0, -0.2, 0.45, 0.7])
    args = (2.0, 1.0, kernel, out_rows, 72, 3.0, 3.0, 3)
    want = _drizzle_kernel_exact(stack, d_ys, d_xs, *args, band_rows=band)
    mesh = cpu_mesh((8,), ("rows",))
    img, wgt, rej = sharded_drizzle(mesh, stack, d_ys, d_xs, *args,
                                    band_rows=band)
    assert _equal(img.full(), want[0]) and _equal(wgt.full(), want[1])
    assert int(rej) == int(want[2])
    if kernel == DrizzleKernel.SQUARE and out_rows == 64:
        jm = jmesh(8, ("rows",), (8,))
        ji, jw, jr = jdrizzle(jm, jnp.asarray(frames), jnp.asarray(d_ys),
                              jnp.asarray(d_xs), 2.0, 1.0, JDK.SQUARE,
                              out_rows, 72, 3.0, 3.0, 3, band_rows=band,
                              use_pallas=False)
        np.testing.assert_allclose(img.full().numpy(), np.asarray(ji),
                                   rtol=1e-6, atol=2e-4)
        np.testing.assert_allclose(wgt.full().numpy(), np.asarray(jw),
                                   atol=1e-5)
        assert int(rej) == int(jr)


def test_drizzle_row0_offset_computes_the_rows_of_the_whole_grid(rng):
    frames = torch.from_numpy(rng.normal(10, 1, (3, 20, 24)).astype(
        np.float32))
    dys, dxs = np.float32([0.0, 0.3, -0.4]), np.float32([0.0, 0.2, 0.1])
    args = (2.0, 0.7, DrizzleKernel.SQUARE)
    whole = _drizzle_kernel_exact(frames, dys, dxs, *args, 40, 48, 3.0, 3.0,
                                  3, band_rows=8)
    part = _drizzle_kernel_exact(frames, dys, dxs, *args, 16, 48, 3.0, 3.0,
                                 3, band_rows=8, row0_offset=16)
    assert _equal(part[0], whole[0][16:32]) and _equal(part[1],
                                                       whole[1][16:32])


# ---- cube ----------------------------------------------------------------


def _cube(rng, b):
    cube = rng.normal(10, 3, (b, 16, 24)).astype(np.float32)
    cube[0, 0, 0] = np.nan
    cube[:, 1, 1] = np.nan  # all-invalid pixel
    cube[: b // 2, 2, 2] = np.inf
    return cube


def test_sharded_cube_mean_matches_eager(rng):
    cube = _cube(rng, 32)
    mesh = cpu_mesh((8,), ("frames",))
    got = sharded_collapse_mean(shard_cube(torch.from_numpy(cube), mesh),
                                mesh).full()
    np.testing.assert_allclose(got.numpy(),
                               collapse_mean(torch.from_numpy(cube)).numpy(),
                               atol=1e-5)
    jm = jmesh(axis_names=("frames",))
    want = jmean(jshard_cube(jnp.asarray(cube), jm), jm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got[1, 1]) == 0.0


@pytest.mark.parametrize("b", [32, 29])
def test_sharded_cube_median_single_rank_convention(rng, b):
    """The finite value of 1-based rank ceil(n/2), exactly; JAX's
    refinement is within range/16^5 of it (held to 2·range/8^6, C31)."""
    cube = _cube(rng, b)
    mesh = cpu_mesh((8,), ("frames",))
    got = sharded_collapse_median(torch.from_numpy(cube), mesh).full()
    srt = np.sort(np.where(np.isfinite(cube), cube, np.inf), axis=0)
    counts = np.isfinite(cube).sum(axis=0)
    ranks = np.ceil(counts * 0.5).astype(int)
    expected = np.take_along_axis(srt, np.clip(ranks - 1, 0, b - 1)[None],
                                  axis=0)[0]
    expected[counts == 0] = 0.0
    np.testing.assert_array_equal(got.numpy(), expected)
    if b % 8 == 0:
        jm = jmesh(axis_names=("frames",))
        want = np.asarray(jmedian(jshard_cube(jnp.asarray(cube), jm), jm))
        fin = cube[np.isfinite(cube)]
        assert np.abs(got.numpy() - want).max() <= 2 * float(
            fin.max() - fin.min()) / 8 ** 6


# ---- compose -------------------------------------------------------------


_WEIGHTS = [
    {"channel_idx": 0, "r_weight": 0.8, "g_weight": 0.1, "b_weight": 0.0},
    {"channel_idx": 1, "r_weight": 0.2, "g_weight": 0.7, "b_weight": 0.1},
    {"channel_idx": 2, "r_weight": 0.0, "g_weight": 0.2, "b_weight": 0.6},
    {"channel_idx": 3, "r_weight": 0.0, "g_weight": 0.0, "b_weight": 0.3},
]


@pytest.fixture(scope="module")
def channels():
    rng = np.random.default_rng(1234)
    chans = rng.gamma(2.0, 40.0, (4, 64, 48)).astype(np.float32)
    chans[0, :3, :5] = 0.0          # padding pixels (v <= 1e-7)
    chans[1, 10, 10] = np.nan       # invalid pixel
    return chans


_COMPOSED = {}


def _composed(chans, wb_mode, linked):
    key = (wb_mode, linked)
    if key not in _COMPOSED:
        wm = torch.from_numpy(blend_weights(len(chans), _WEIGHTS))
        args = (torch.from_numpy(chans), wm, [1.3, 1.0, 0.8])
        kw = dict(wb_mode=wb_mode, linked_stf=linked, exact_pair=True)
        _COMPOSED[key] = (
            make_sharded_compose(cpu_mesh((8,), ("rows",)), "rows",
                                 **kw)(*args),
            make_sharded_compose(cpu_mesh((1,), ("rows",)), "rows",
                                 **kw)(*args))
    return _COMPOSED[key]


def _process_rgb(chans, wb_mode, linked):
    r, g, b = blend_channels([torch.from_numpy(c) for c in chans], _WEIGHTS)
    wb = WhiteBalance(mode=WhiteBalanceMode(wb_mode), r=1.3, g=1.0, b=0.8)
    return process_rgb(r, g, b, RgbComposeConfig(
        white_balance=wb, align=False, auto_stretch=True, linked_stf=linked))


@pytest.mark.parametrize("wb_mode,linked", [("auto", True),
                                            ("manual", False)])
def test_sharded_compose_matches_process_rgb(channels, wb_mode, linked):
    out, one = _composed(channels, wb_mode, linked)
    for k in ("rgb", "preview"):
        assert torch.equal(out[k].full(), one[k].full()), k
    assert torch.equal(out["stf"], one["stf"])
    ref = _process_rgb(channels, wb_mode, linked)
    got = out["rgb"].full()
    for k, plane in enumerate([ref.r, ref.g, ref.b]):
        np.testing.assert_allclose(got[k].numpy(), plane.numpy(), atol=2e-5)
    stf = out["stf"].numpy()
    for k, p in enumerate([ref.stf_r, ref.stf_g, ref.stf_b]):
        np.testing.assert_allclose(stf[k], [p.shadow, p.midtone], atol=1e-5)
    if linked:
        assert (stf[0] == stf[1]).all() and (stf[1] == stf[2]).all()
    else:
        np.testing.assert_allclose(out["wb"].numpy(), [1.3, 1.0, 0.8])


def test_sharded_compose_matches_jax_sharded_compose(channels):
    out, _ = _composed(channels, "auto", True)
    jm = jmesh(8, ("rows",), (8,))
    compose = jcompose(jm, "rows", wb_mode="auto", linked_stf=True,
                       exact_pair=True)
    sharded = jax.device_put(jnp.asarray(channels),
                             NamedSharding(jm, P(None, "rows", None)))
    want = compose(sharded, jnp.asarray(blend_weights(4, _WEIGHTS)),
                   jnp.asarray([1.3, 1.0, 0.8], jnp.float32))
    np.testing.assert_allclose(out["rgb"].full().numpy(),
                               np.asarray(want["rgb"]), atol=2e-5)
    np.testing.assert_allclose(out["stf"].numpy(), np.asarray(want["stf"]),
                               atol=1e-5)
    np.testing.assert_allclose(out["wb"].numpy(), np.asarray(want["wb"]),
                               rtol=1e-5)


def test_sharded_compose_wb_picks_stable_reference(channels):
    out, _ = _composed(channels, "auto", True)
    wb = out["wb"].numpy()
    assert (wb == 1.0).any()
    assert np.isfinite(wb).all() and (wb > 0).all()


def test_sharded_compose_invalid_pixels_render_black(channels):
    out, _ = _composed(channels, "auto", True)
    got = out["rgb"].full().numpy()
    assert got[0, 10, 10] == 0.0
    assert np.isfinite(got).all()
    prev = out["preview"].full().numpy()
    assert prev.dtype == np.uint8
    np.testing.assert_array_equal(
        prev, np.clip(np.round(got * 255.0), 0, 255).astype(np.uint8))


def test_parallel_exports_match_the_jax_package():
    import astroburst_tpu.parallel as jp
    assert tp.__all__ == jp.__all__ == ["make_mesh", "align_stack_stretch",
                                        "make_sharded_stack_step"]
