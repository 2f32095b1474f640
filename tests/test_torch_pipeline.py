"""PyTorch port: the align → stack → stretch slice as a whole against the
JAX package.

- ``align_stack_stretch`` against JAX ``align_stack_stretch(
  use_pallas=False)`` (the XLA path: shift_bicubic + sigma_clip_core,
  which is exactly the port's plain path on the CPU);
- ``stack_images`` against JAX ``stack_images``, also past 128 frames.

Tolerances: offsets atol 0.05 px and confidences rtol 1e-3 (as in
test_torch_phase_correlation.py); combined planes under the flip bound
of tests/test_onepass_kernel.py (≤ 3 pixels off by more than 5e-3,
rejected counts within 3; at 150 frames chip_smoke.py's form of it,
1e-5 of the pixel-frames); data range exact; STF parameters within
1e-4 (the JAX median/MAD are compare-count values within range/8**6
of the exact ones the port takes). Through those parameters the u8
preview may move by one grey level where a pixel sits near a rounding
boundary: ≤ 1 everywhere, on ≤ 0.5% of the pixels (measured ~0.12% on
these frames). The JAX phase correlation runs with its sub-pixel step
held to the parabola vertex (``jax_parabola_vertex``, ROADMAP C8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from astroburst_tpu.dtypes import StackConfig
from astroburst_tpu.parallel.pipeline import (
    align_stack_stretch as jax_pipeline)
from astroburst_tpu.stacking.combine import stack_images as jax_stack
from astroburst_tpu_torch.alignment.coarse_kernel import (
    coarse_downsample_stack)
from astroburst_tpu_torch.convert import stack_from_numpy
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.ops.crop_kernel import gather_crops
from astroburst_tpu_torch.parallel import align_stack_stretch
from astroburst_tpu_torch.stacking.combine import stack_images
from astroburst_tpu_torch.stacking.onepass_kernel import shift_clip_onepass
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = {"combined", "preview", "offsets", "confidences", "rejected", "stf",
        "data_range"}
WRAPPERS = (shift_clip_onepass, coarse_downsample_stack, gather_crops)


def _flips(got, want, got_rej, want_rej, max_flips=3):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert int((d > 5e-3).sum()) <= max_flips, d.max()
    assert abs(int(got_rej) - int(want_rej)) <= max_flips


@pytest.fixture(scope="module")
def frames():
    return bench.make_frames(4, 600, 700, seed=5)


@pytest.fixture(scope="module")
def jax_out(frames):
    out = jax_pipeline(jnp.asarray(frames), use_pallas=False)
    return {k: np.asarray(v) for k, v in out.items()}


def test_align_stack_stretch_matches_jax(frames, jax_out):
    launches = [f.launches for f in WRAPPERS]
    out = align_stack_stretch(stack_from_numpy(frames, CPU))
    assert [f.launches for f in WRAPPERS] == launches  # CPU: no launches
    assert set(out) == KEYS == set(jax_out)
    got = {k: v.numpy() for k, v in out.items()}
    assert got["preview"].dtype == np.uint8
    assert got["offsets"].shape == (4, 2) and got["offsets"][0].tolist() == [
        0.0, 0.0]
    np.testing.assert_allclose(got["offsets"], jax_out["offsets"], atol=0.05)
    np.testing.assert_allclose(got["confidences"], jax_out["confidences"],
                               rtol=1e-3)
    _flips(got["combined"], jax_out["combined"], got["rejected"],
           jax_out["rejected"])
    np.testing.assert_array_equal(got["data_range"], jax_out["data_range"])
    np.testing.assert_allclose(got["stf"], jax_out["stf"], atol=1e-4)
    d = np.abs(got["preview"].astype(np.int32) -
               jax_out["preview"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3


def test_align_stack_stretch_recovers_bench_shifts(frames):
    """The offsets are the integer shifts bench.make_frames applied."""
    from chip_smoke import bench_shifts

    out = align_stack_stretch(stack_from_numpy(frames, CPU))
    np.testing.assert_allclose(out["offsets"].numpy(),
                               bench_shifts(4, 600, 700, seed=5), atol=0.05)


@pytest.mark.parametrize("align,exact_pair", [(False, False), (True, True)])
def test_align_stack_stretch_options_match_jax(rng, align, exact_pair):
    s = bench.make_frames(3, 520, 560, seed=9)
    s[1, 10:12, 20:22] = np.nan
    out = align_stack_stretch(stack_from_numpy(s, CPU), 2.5, 3.0, 4,
                              align=align, exact_pair=exact_pair)
    want = jax_pipeline(jnp.asarray(s), 2.5, 3.0, 4, align=align,
                        exact_pair=exact_pair, use_pallas=False)
    np.testing.assert_allclose(out["offsets"].numpy(),
                               np.asarray(want["offsets"]), atol=0.05)
    _flips(out["combined"].numpy(), want["combined"], out["rejected"],
           want["rejected"])
    np.testing.assert_allclose(out["stf"].numpy(), np.asarray(want["stf"]),
                               atol=1e-4)


class _Progress:
    def __init__(self):
        self.calls = []

    def tick_with_stage(self, stage, n=1):
        self.calls.append((stage, n))

    def check_cancelled(self):
        self.calls.append("check")


def test_stack_images_matches_jax(frames):
    images = [frames[0], frames[1][:590], frames[2][:, :695], frames[3]]
    prog = _Progress()
    got = stack_images([torch.from_numpy(f.copy()) for f in images],
                       StackConfig(max_iterations=4), prog)
    want = jax_stack(images, StackConfig(max_iterations=4))
    assert got.frame_count == want.frame_count == 4
    assert got.image.shape == (590, 695)
    assert got.offsets == want.offsets
    np.testing.assert_allclose(got.confidences, want.confidences, rtol=1e-3)
    _flips(got.image.numpy(), np.asarray(want.image), got.rejected_pixels,
           want.rejected_pixels)
    assert prog.calls == [("align", 3), "check", ("combine", 1)]


def test_stack_images_without_alignment(frames):
    cfg = StackConfig(align=False, sigma_low=2.0, sigma_high=2.5)
    got = stack_images(list(frames), cfg, device=CPU)
    want = jax_stack(list(frames), cfg)
    assert got.offsets == want.offsets == [(0, 0)] * 4
    assert got.confidences == [0.0] * 4
    _flips(got.image.numpy(), np.asarray(want.image), got.rejected_pixels,
           want.rejected_pixels)


def test_stack_images_rejects_empty():
    with pytest.raises(InvalidInput):
        stack_images([], device=CPU)


def test_stack_images_past_128_frames_matches_jax():
    """150 frames: past K3's shared-memory instance (its scratch instance
    on the card; the plain version here). The image, offsets, rejected
    count and confidences against JAX ``stack_images`` on the CPU."""
    frames = bench.make_frames(150, 192, 224, seed=13)
    frames[7, 30:33, 40:42] = np.nan
    frames[9, 50, 60] = np.inf
    got = stack_images([torch.from_numpy(f.copy()) for f in frames])
    want = jax_stack(list(frames))
    assert got.frame_count == want.frame_count == 150
    assert got.offsets == want.offsets
    np.testing.assert_allclose(got.confidences, want.confidences, rtol=1e-3)
    # the flip bound of chip_smoke.py (1e-5 of the pixel-frames; 3 at the
    # shapes above): each of a pixel's 150 values can be the borderline
    # one that the sub-pixel offsets' last ulp moves across a bound
    _flips(got.image.numpy(), np.asarray(want.image), got.rejected_pixels,
           want.rejected_pixels, max_flips=int(1e-5 * frames.size))
