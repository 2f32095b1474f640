"""PyTorch port: the collective contracts of every sharded path
(counterpart of tests/test_collective_contracts.py and of the
no-reshard test of tests/test_parallel_compose.py).

The JAX tests read the compiled HLO; the port's mesh counts instead:
each collective adds the elements it moved to ``mesh.moved[op]`` (a
piece a shard keeps is not moved) and one to ``mesh.calls[op]``. The
contracts, on 8 CPU shards at the JAX tests' shapes:

- the frames→rows all-to-all moves one shard's pieces and no more:
  each shard receives its row block of every frame and keeps the 1/F
  that was its own;
- the halo exchange moves halo rows to each neighbour, 2·halo rows a
  shard inside the image (halo = ceil(max |dy|) + 2), nothing more;
- nothing moves a whole plane in the step, compose, drizzle, à trous or
  cube paths: the reductions move scalars (the cube's per-pixel sums
  and counts excepted, which are its result), and the only broadcasts
  are the inputs every shard needs (frame 0; the drizzle's stack and
  the warp's image, replicated as in the JAX package);
- the FFT makes exactly one all-to-all a transform, two a round trip.
"""

import math

import numpy as np
import pytest
import torch

from astroburst_tpu_torch.dtypes import DrizzleKernel, RLConfig
from astroburst_tpu_torch.parallel.compose import make_sharded_compose
from astroburst_tpu_torch.parallel.cube import (shard_cube,
                                                sharded_collapse_mean,
                                                sharded_collapse_median)
from astroburst_tpu_torch.parallel.drizzle import sharded_drizzle
from astroburst_tpu_torch.parallel.fft import (sharded_deconvolve,
                                               sharded_fft2, sharded_ifft2,
                                               sharded_power_spectrum)
from astroburst_tpu_torch.parallel.halo import sharded_atrous_smooth
from astroburst_tpu_torch.parallel.mesh import make_mesh, shard
from astroburst_tpu_torch.parallel.pipeline import (
    make_sharded_stack_step, sharded_shift_clip, sharded_shift_clip_a2a)
from astroburst_tpu_torch.parallel.warp import make_sharded_warp
from astroburst_tpu_torch.alignment.affine import AffineTransform
from astroburst_tpu_torch.stacking.onepass_kernel import slab_halo

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(shape, axes):
    return make_mesh([CPU] * int(np.prod(shape)), axes, shape)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _offsets(rng, n, off):
    d = rng.uniform(-off, off, (2, n)).astype(np.float32)
    d[:, 0] = 0.0
    return d


# --- 1. stacking: the frames→rows all-to-all and the halo permutes ---------


def test_contract_sharded_shift_clip_a2a(rng):
    n, h, w = 8, 256, 256
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    stack = torch.from_numpy(rng.normal(100, 3, (n, h, w)).astype(
        np.float32))
    dys, dxs = _offsets(rng, n, 3.0)
    placed = shard(mesh, stack, 0, "frames")
    mesh.reset_counts()
    sharded_shift_clip_a2a(mesh, placed, dys, dxs, "frames", "rows", 3.0,
                           3.0, 2)
    local_h, halo = h // 8, slab_halo(dys)
    assert mesh.calls["all_to_all"] == 1
    # every shard receives all n frames of its block and keeps 1/4
    assert mesh.moved["all_to_all"] == 8 * n * local_h * w * 3 // 4
    # halo rows to each of the 7 neighbour pairs, both ways
    assert mesh.calls["ppermute"] == 2
    assert mesh.moved["ppermute"] == 2 * 7 * n * halo * w
    assert set(mesh.calls) == {"all_to_all", "ppermute", "psum"}
    assert mesh.moved["psum"] == 2 * 7     # the rejected counts


def test_contract_sharded_shift_clip_rows(rng):
    n, h, w = 6, 96, 64
    mesh = cpu_mesh((8,), ("rows",))
    stack = torch.from_numpy(rng.normal(100, 3, (n, h, w)).astype(
        np.float32))
    dys, dxs = _offsets(rng, n, 7.0)
    placed = shard(mesh, stack, 1, "rows", pad_edge=True)
    mesh.reset_counts()
    sharded_shift_clip(mesh, placed, dys, dxs, "rows", 3.0, 3.0, 3)
    halo = slab_halo(dys)
    assert set(mesh.calls) == {"ppermute", "psum"}
    assert mesh.moved["ppermute"] == 2 * 7 * n * halo * w


def test_contract_sharded_stack_step(rng):
    """Frame 0 broadcast, one all-to-all, the halo permutes, and
    reductions of scalars: no plane is gathered or reduced."""
    n, h, w = 8, 128, 64
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    base += 500.0 * np.exp(-((yy - 64) ** 2 + (xx - 32) ** 2) / 8.0)
    shifts = [(0, 0), (1, 2), (-2, 1), (2, -1), (0, 3), (-1, -2), (3, 0),
              (-3, 2)]
    frames = np.stack([np.roll(base, s, (0, 1)) for s in shifts])
    mesh = cpu_mesh((4, 2), ("frames", "rows"))
    step = make_sharded_stack_step(mesh, max_iter=2)
    placed = shard(mesh, torch.from_numpy(frames), 0, "frames")
    mesh.reset_counts()
    out = step(placed)
    assert mesh.calls["all_to_all"] == 1
    assert mesh.moved["all_to_all"] == 8 * n * (h // 8) * w * 3 // 4
    halo = slab_halo(out["offsets"][:, 0])
    assert mesh.moved["ppermute"] == 2 * 7 * n * halo * w
    assert mesh.calls["broadcast"] == 1
    assert mesh.moved["broadcast"] == 8 * h * w     # frame 0
    assert set(mesh.calls) == {"broadcast", "all_to_all", "ppermute",
                               "psum", "pmin", "pmax"}
    # scalars only, each reduced to one shard and sent back to 7: the
    # offsets [3, n] once; the rejected, valid and summed counts; one
    # count for each of the 32 bisection rounds of the median and MAD
    assert mesh.moved["pmin"] == mesh.moved["pmax"] == 14
    assert mesh.moved["psum"] == 14 * (3 * n + 3 + 2 * 32) < h * w


# --- 2. distributed FFT: one all-to-all a transform, nothing gathered ------


def test_contract_sharded_fft2(rng):
    mesh = cpu_mesh((8,), ("rows",))
    xr = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32))
    gr, gi = sharded_fft2(mesh, xr, torch.zeros_like(xr))
    assert mesh.calls == {"all_to_all": 1}
    assert mesh.moved["all_to_all"] == 512 * 512 * 7 // 8
    sharded_ifft2(mesh, gr, gi)
    assert mesh.calls == {"all_to_all": 2}


def test_contract_sharded_deconvolve(rng):
    mesh = cpu_mesh((8,), ("rows",))
    img = torch.from_numpy(rng.normal(50, 4, (256, 256)).astype(
        np.float32))
    psf = np.ones((9, 9), np.float32) / 81.0
    sharded_deconvolve(mesh, img, psf, RLConfig(iterations=2, dering=True))
    # two convolutions an iteration, each a round trip
    assert mesh.calls["all_to_all"] == 2 * 2 * 2
    assert mesh.calls["psum"] == 2 and mesh.moved["psum"] == 2 * 14
    assert set(mesh.calls) == {"all_to_all", "psum"}


def test_contract_sharded_power_spectrum(rng):
    mesh = cpu_mesh((8,), ("rows",))
    img = torch.from_numpy(rng.normal(10, 2, (200, 180)).astype(np.float32))
    sharded_power_spectrum(mesh, img, True)
    assert mesh.calls == {"all_to_all": 2}


# --- 3. drizzle: per-shard work, one scalar psum --------------------------


def test_contract_sharded_drizzle(rng):
    mesh = cpu_mesh((8,), ("rows",))
    stack = torch.from_numpy(rng.normal(100, 3, (4, 64, 64)).astype(
        np.float32))
    dys, dxs = _offsets(rng, 4, 1.0)
    sharded_drizzle(mesh, stack, dys, dxs, 2.0, 0.8, DrizzleKernel.SQUARE,
                    128, 128, 3.0, 3.0, 2, band_rows=8)
    # the stack and its offsets replicated, as the JAX package does; the
    # rejected count the only value that crosses shards after
    assert mesh.calls == {"broadcast": 2, "psum": 1}
    assert mesh.moved["broadcast"] == 8 * (4 * 64 * 64 + 2 * 4)
    assert mesh.moved["psum"] == 14


# --- 4. compose: reductions only ------------------------------------------


def test_contract_sharded_compose(rng):
    mesh = cpu_mesh((8,), ("rows",))
    compose = make_sharded_compose(mesh)
    chans = torch.from_numpy(rng.normal(100, 10, (3, 256, 256)).astype(
        np.float32))
    compose(chans, torch.eye(3), [1.0, 1.0, 1.0])
    assert set(mesh.calls) == {"broadcast", "psum", "pmin", "pmax"}
    assert mesh.moved["broadcast"] == 8 * 9       # the weights
    # scalars only, each reduced to one shard and sent back to 7, for
    # each of the 7 stats (3 channels before and after the white balance,
    # the merged plane): the valid count, the sum, 32 bisection rounds of
    # the median and of the MAD; min and max once each
    assert mesh.moved["psum"] == 7 * 14 * (2 + 2 * 32) < 256 * 256
    assert mesh.moved["pmin"] == mesh.moved["pmax"] == 7 * 14


# --- 5. warp: no collective beyond the input --------------------------------


def test_contract_sharded_warp(rng):
    mesh = cpu_mesh((8,), ("rows",))
    th = math.radians(0.5)
    ct, st = math.cos(th), math.sin(th)
    warp = make_sharded_warp(mesh, AffineTransform(
        a=ct, b=-st, tx=2.0, c=st, d=ct, ty=-1.0), 512, 512)
    warp(torch.from_numpy(rng.normal(100, 5, (512, 512)).astype(
        np.float32)))
    assert mesh.calls == {"broadcast": 1}
    assert mesh.moved["broadcast"] == 8 * 512 * 512


# --- 6. halo stencil: permutes only -----------------------------------------


@pytest.mark.parametrize("step", [1, 2])
def test_contract_sharded_atrous(rng, step):
    mesh = cpu_mesh((8,), ("rows",))
    x = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32))
    sharded_atrous_smooth(x, mesh, "rows", step)
    assert mesh.calls == {"ppermute": 2}
    assert mesh.moved["ppermute"] == 2 * 7 * (2 * step) * 512


# --- 7. cube collapses: reductions over frames ------------------------------


def test_contract_sharded_cube_collapse(rng):
    mesh = cpu_mesh((8,), ("frames",))
    cube = shard_cube(torch.from_numpy(rng.normal(100, 5, (16, 64, 64))
                                       .astype(np.float32)), mesh)
    mesh.reset_counts()
    sharded_collapse_mean(cube, mesh)
    assert mesh.calls == {"psum": 2}        # the sums and the counts
    assert mesh.moved["psum"] == 2 * 14 * 64 * 64
    mesh.reset_counts()
    sharded_collapse_median(cube, mesh)
    assert mesh.calls == {"psum": 1 + 32}   # the counts, 32 bisections
