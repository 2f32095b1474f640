"""PyTorch port: the sigma clip and the plain version of kernel K3
(shift + clip) against the JAX package.

- ``sigma_clip_core`` against JAX ``sigma_clip_core``: rtol 1e-6 and
  equal rejected counts (the same f32 operations in the same order);
- K3's plain version against the one-pass Pallas kernel in interpret
  mode (offsets within its ±16 clamp), and at N=24 with offsets up to
  ±200 (the two-stage kernel's range) against JAX shift_bicubic +
  sigma_clip_core, under the bound of tests/test_onepass_kernel.py:
  (this bound also holds K3 to TPU kernels 5 and 6: the rolling-ring
  one-pass kernel and the clip-only kernel at zero offsets)
  at most 3 pixels differ by more than 5e-3, and the rejected counts by
  at most 3 (borderline clip decisions flip on the last ulp when tap
  sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.ops.resample import shift_bicubic as jshift
from astroburst_tpu.stacking.clip_kernel import sigma_clip_pallas as jclip6
from astroburst_tpu.stacking.combine import sigma_clip_core as jclip
from astroburst_tpu.stacking.rolling_kernel import (
    pad_rows_rolling, ring_dims, shift_clip_rolling_padded as jk5)
from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass as jk3
from astroburst_tpu_torch.convert import stack_from_numpy
from astroburst_tpu_torch.stacking.clip import sigma_clip_core
from astroburst_tpu_torch.stacking import onepass_kernel as tok
from astroburst_tpu_torch.stacking.onepass_kernel import (
    shift_clip_onepass, shift_clip_onepass_plain)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _stack(rng, n, h, w, nan_frac=0.02):
    s = rng.normal(100, 5, (n, h, w)).astype(np.float32)
    s[rng.random(s.shape) < nan_frac] = np.nan
    return s


def _assert_close(got, ref, got_rej, ref_rej, max_flips=3):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    flips = int((d > 5e-3).sum())
    assert flips <= max_flips, f"{flips} pixels differ, max |d|={d.max()}"
    assert abs(int(got_rej) - int(ref_rej)) <= max_flips


def _clip_both(s, lo, hi, iters):
    got, grej = sigma_clip_core(stack_from_numpy(s, CPU), lo, hi, iters)
    want, wrej = jax.jit(lambda x: jclip(x, lo, hi, iters))(jnp.asarray(s))
    return got.numpy(), int(grej), np.asarray(want), int(wrej)


@pytest.mark.parametrize("n,lo,hi,iters,nan_frac", [
    (8, 3.0, 3.0, 5, 0.0), (8, 2.5, 3.0, 5, 0.05), (16, 1.0, 1.5, 5, 0.02),
    (5, 3.0, 3.0, 1, 0.1), (6, 3.0, 3.0, 0, 0.02), (2, 3.0, 3.0, 5, 0.0),
    (1, 3.0, 3.0, 5, 0.0), (7, 0.3, 0.2, 5, 0.0)])
def test_sigma_clip_core_matches_jax(rng, n, lo, hi, iters, nan_frac):
    s = _stack(rng, n, 40, 57, nan_frac)
    s[:, 0, 0] = np.nan                   # no finite value: 0
    s[:, 0, 1] = 42.0                     # constant pixel
    s[:-1, 0, 2] = np.nan                 # one finite value
    s[0, 1, 1] = 1e4                      # an outlier
    got, grej, want, wrej = _clip_both(s, lo, hi, iters)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert grej == wrej


def test_sigma_clip_core_rejects_cosmic_ray(rng):
    s = rng.normal(100, 1, (10, 8, 8)).astype(np.float32)
    s[3, 4, 4] = 5000.0
    got, rej = sigma_clip_core(torch.from_numpy(s))
    assert abs(got[4, 4].item() - 100.0) < 2.0
    assert rej.item() >= 1


@pytest.mark.parametrize("seed_offset", [0, 1])
def test_k3_plain_matches_onepass_interpret(rng, seed_offset):
    """Offsets inside the TPU kernel's ±16 clamp, NaN pixels, a frame
    with an exact zero offset besides frame 0."""
    s = _stack(rng, 6, 130, 170)
    dys = rng.uniform(-12, 12, 6).astype(np.float32)
    dxs = rng.uniform(-12, 12, 6).astype(np.float32)
    dys[0] = dxs[0] = 0.0
    if seed_offset:
        dys[3] = dxs[3] = 0.0
        dys[1], dxs[1] = 16.0, -15.5
    got, grej = shift_clip_onepass(stack_from_numpy(s, CPU),
                                   torch.from_numpy(dys),
                                   torch.from_numpy(dxs), 2.5, 3.0, 5)
    want, wrej = jk3(jnp.asarray(s), jnp.asarray(dys), jnp.asarray(dxs),
                     2.5, 3.0, 5, interpret=True)
    _assert_close(got.numpy(), want, grej, wrej)


def test_k3_plain_wide_offsets_many_frames(rng):
    """N=24 with offsets up to ±200 (beyond the one-pass kernel's clamp,
    inside the two-stage kernel's): no clamp, as shift_bicubic."""
    s = _stack(rng, 24, 240, 260, nan_frac=0.01)
    dys = rng.uniform(-200, 200, 24).astype(np.float32)
    dxs = rng.uniform(-200, 200, 24).astype(np.float32)
    dys[0] = dxs[0] = 0.0
    got, grej = shift_clip_onepass_plain(stack_from_numpy(s, CPU),
                                         torch.from_numpy(dys),
                                         torch.from_numpy(dxs), 3.0, 3.0, 5)
    shifted = jnp.stack([jshift(jnp.asarray(s[k]), float(dys[k]),
                                float(dxs[k])) for k in range(24)])
    want, wrej = jax.jit(lambda x: jclip(x, 3.0, 3.0, 5))(shifted)
    _assert_close(got.numpy(), want, grej, wrej)


def test_k3_wrapper_on_cpu_is_the_plain_version(rng):
    s = _stack(rng, 4, 50, 60)
    dys = np.float32([0.0, 1e-13, 2.5, -3.75])
    dxs = np.float32([0.0, 0.0, -1.25, 30.0])
    before = shift_clip_onepass.launches
    a = shift_clip_onepass(torch.from_numpy(s), dys, dxs, 3.0, 3.0, 5)
    b = shift_clip_onepass_plain(torch.from_numpy(s), dys, dxs, 3.0, 3.0, 5)
    assert shift_clip_onepass.launches == before
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert int(a[1]) == int(b[1])


@pytest.mark.parametrize("off_max,lo,hi,iters", [(6, 2.5, 3.0, 5),
                                                 (16, 3.0, 3.0, 3)])
def test_k3_plain_matches_rolling_kernel(rng, off_max, lo, hi, iters):
    """TPU kernel 5, the rolling-ring schedule of the one-pass kernel,
    on the shapes of tests/test_rolling_kernel.py: K3 replaces it.
    Through the JAX dispatcher (``rolling=True`` on a stack padded for
    the ring) and through the kernel itself."""
    s = _stack(rng, 5, 100, 1300)
    n, h, w = s.shape
    dys = rng.uniform(-off_max, off_max, n).astype(np.float32)
    dxs = rng.uniform(-off_max, off_max, n).astype(np.float32)
    dys[0] = dxs[0] = 0.0
    hp = pad_rows_rolling(h, 16, off_max)
    wp = max(-(-w // 128) * 128, ring_dims(16, 1152, off_max)[1])
    padded = jnp.pad(jnp.asarray(s), ((0, 0), (0, hp - h), (0, wp - w)))
    want, wrej = jk5(padded, jnp.asarray(dys), jnp.asarray(dxs), h, w, lo,
                     hi, iters, off_max=off_max, interpret=True)
    via, vrej = jk3(padded, jnp.asarray(dys), jnp.asarray(dxs), lo, hi,
                    iters, off_max=off_max, true_shape=(h, w),
                    interpret=True, adaptive=False, rolling=True)
    np.testing.assert_array_equal(np.asarray(via), np.asarray(want))
    assert int(vrej) == int(wrej)
    got, grej = shift_clip_onepass_plain(stack_from_numpy(s, CPU),
                                         torch.from_numpy(dys),
                                         torch.from_numpy(dxs), lo, hi, iters)
    _assert_close(got.numpy(), want, grej, wrej)


@pytest.mark.parametrize("n,lo,hi,iters", [(6, 3.0, 3.0, 5),
                                           (9, 2.0, 2.5, 4)])
def test_k3_at_zero_offsets_matches_clip_kernel(rng, n, lo, hi, iters):
    """TPU kernel 6, the clip-only kernel: K3 at exact zero offsets."""
    s = _stack(rng, n, 40, 300)
    s[2, 5, 7] = 1e4
    zeros = torch.zeros(n)
    got, grej = shift_clip_onepass(stack_from_numpy(s, CPU), zeros, zeros,
                                   lo, hi, iters)
    want, wrej = jclip6(jnp.asarray(s), lo, hi, iters, interpret=True)
    _assert_close(got.numpy(), want, grej, wrej)


# every (h, w) that chip_smoke.py gives K3, and the extremes of a plane
PLAN_PLANES = ((5655, 2206), (2048, 2048), (1024, 1024), (300, 400),
               (40, 56), (1, 1), (1, 100000), (8192, 8192))


@pytest.mark.parametrize("n", range(1, 401))
def test_k3_plan_holds_every_frame_count(n):
    """Every n gets an instance that holds it (no refusal): registers up
    to 32 frames at CAP = n rounded up to a multiple of 4, shared memory
    for 33..128 frames within a block's 232,448 bytes, past that the
    global scratch over bands that cover the plane within
    SCRATCH_MAX_BYTES."""
    for h, w in PLAN_PLANES:
        plan = tok._clip_plan(n, h, w)
        assert plan.block_rows * 32 <= 256
        assert plan.smem_bytes <= tok.MAX_SHARED_BYTES == 232448
        if plan.instance == "registers":
            assert n <= plan.cap <= tok.MAX_REG_FRAMES == 32
            assert plan.cap % 4 == 0 and plan.cap - n < 4
            assert (plan.smem_bytes, plan.band_rows) == (0, h)
        elif plan.instance == "shared":
            assert 32 < n <= tok.MAX_SHARED_FRAMES
            assert plan.smem_bytes == 2 * n * 4 * 32 * plan.block_rows
            assert plan.block_rows == 8 or \
                2 * n * 4 * 32 * 8 > tok.MAX_SHARED_BYTES
            assert (plan.cap, plan.band_rows) == (0, h)
        else:
            assert plan.instance == "scratch" and n > tok.MAX_SHARED_FRAMES
            assert 1 <= plan.band_rows <= h and plan.cap == 0
            assert plan.band_rows == 1 or \
                n * plan.band_rows * w * 4 <= tok.SCRATCH_MAX_BYTES
            assert plan.band_rows == h or \
                n * (plan.band_rows + 1) * w * 4 > tok.SCRATCH_MAX_BYTES


@pytest.mark.parametrize("n", [150, 300])
def test_k3_plain_past_128_frames_matches_jax(rng, n):
    """Past K3's shared-memory instance (the scratch instance on the
    card): JAX shift_bicubic + sigma_clip_core, NaN/inf pixels, offsets
    up to ±30."""
    s = _stack(rng, n, 36, 44, nan_frac=0.02)
    s[: n // 2, 5, 9] = np.inf
    s[1, 20, 30] = -np.inf
    s[2, 10, 10] = 5000.0
    dys = rng.uniform(-30, 30, n).astype(np.float32)
    dxs = rng.uniform(-30, 30, n).astype(np.float32)
    dys[0] = dxs[0] = 0.0
    dys[n // 3] = dxs[n // 3] = 0.0
    got, grej = shift_clip_onepass(stack_from_numpy(s, CPU),
                                   torch.from_numpy(dys),
                                   torch.from_numpy(dxs), 2.5, 3.0, 5)
    shifted = jax.jit(jax.vmap(jshift))(jnp.asarray(s), jnp.asarray(dys),
                                        jnp.asarray(dxs))
    want, wrej = jax.jit(lambda x: jclip(x, 2.5, 3.0, 5))(shifted)
    _assert_close(got.numpy(), want, grej, wrej)
