"""PyTorch port: the device dedupe, the masked stretch and its RGB form
against the JAX package.

Inputs are made with numpy from a seed and fed to both packages (JAX on
its XLA route on the CPU, at ≤ 256² and ``max_peaks`` ≤ 256).
Tolerances:

- ``dedupe_packed_device``: the accept set equal to JAX's and to the
  host greedy of ``_postprocess_packed``;
- the masked stretch at ``convergence_threshold=0`` (the JAX bench's
  fixed ×10 configuration, bench_ops.py:168-169), where no stop test can
  fire: iterations_run, stars_masked and the coverage equal; the image
  within 1e-4 and final_background within 1e-5. The port's masked
  median is the exact order statistic, JAX's the compare-count value
  within ~4e-6 of it on [0, 1] (ROADMAP C12), and the two star masks
  differ by the FMA contraction of XLA on the CPU (≤ 1e-6, ROADMAP C13);
- at the default threshold, the stop tests can fall on another iteration
  than JAX's, so the port is held to a numpy oracle of the reference
  semantics with exact selection (np.partition), run on the port's own
  mask: iterations_run and converged equal, the image within 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.analysis import star_detection as jsd
from astroburst_tpu_torch.analysis import star_detection as tsd
from astroburst_tpu_torch.imaging.star_mask import _mask_kernel

jms = importlib.import_module("astroburst_tpu.imaging.masked_stretch")
tms = importlib.import_module("astroburst_tpu_torch.imaging.masked_stretch")

torch.set_num_threads(1)

CPU = torch.device("cpu")
MAX_PEAKS = 256


def _field(h=256, w=256, n=60, seed=3, bg=0.1):
    """Gaussian stars (FWHM ~4 px) of peak 0.2-0.9 on a 0.1 background
    with noise 0.005."""
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, 0.005, (h, w))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for cy, cx, a in zip(rng.uniform(5, h - 5, n), rng.uniform(5, w - 5, n),
                         rng.uniform(0.2, 0.9, n)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.8 ** 2))
    return img.astype(np.float32)


# ---- dedupe_packed_device ----------------------------------------------------


def _packed_clusters(rng, k=256, n_clusters=30):
    """[10, k] packed records: clusters of 2-4 candidates within 3 px
    (the conflicts), isolated candidates, invalid slots with NaN
    positions, random fluxes."""
    packed = np.zeros((10, k), np.float32)
    ys, xs = [], []
    for _ in range(n_clusters):
        cy, cx = rng.uniform(10, 500, 2)
        for _ in range(rng.integers(2, 5)):
            ys.append(cy + rng.uniform(-2.0, 2.0))
            xs.append(cx + rng.uniform(-2.0, 2.0))
    while len(ys) < k - 20:
        ys.append(rng.uniform(0, 510))
        xs.append(rng.uniform(0, 510))
    n = len(ys)
    packed[0, :n], packed[1, :n] = ys, xs
    packed[0, n:] = packed[1, n:] = np.nan
    packed[2] = rng.uniform(1.0, 100.0, k)
    packed[3] = rng.uniform(1.0, 5.0, k)
    packed[8, :n] = (rng.random(n) < 0.9).astype(np.float32)
    perm = rng.permutation(k)
    packed[:9] = packed[:9, perm]
    return packed


def _host_accept_set(packed):
    """(y, x) of the stars ``_postprocess_packed`` keeps."""
    det = jsd._postprocess_packed(packed, 5.0, 600, 600)
    return sorted((np.float32(s.y), np.float32(s.x)) for s in det.stars)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedupe_packed_device_matches_jax_and_host(seed):
    packed = _packed_clusters(np.random.default_rng(seed))
    want = np.asarray(jsd.dedupe_packed_device(jnp.asarray(packed)))
    got = tsd.dedupe_packed_device(torch.from_numpy(packed.copy()))
    assert got.dtype == torch.bool and got.shape == (packed.shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = got.numpy()
    assert sorted(zip(packed[0, acc], packed[1, acc])) == \
        _host_accept_set(packed)
    conflicted_valid = packed[8] > 0.5
    assert 0 < acc.sum() < conflicted_valid.sum()   # some were suppressed


def test_dedupe_scan_cap_truncates_as_jax():
    """Past scan_cap conflicted candidates the dimmest extras are dropped
    — the same truncation as JAX's."""
    packed = _packed_clusters(np.random.default_rng(5), n_clusters=40)
    want = np.asarray(jsd.dedupe_packed_device(jnp.asarray(packed),
                                               scan_cap=16))
    got = tsd.dedupe_packed_device(torch.from_numpy(packed.copy()),
                                   scan_cap=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedupe_on_detection_records_matches_jax():
    img = _field()
    packed = np.asarray(jsd._detect_fused(jnp.asarray(img), 32, 5.0,
                                          MAX_PEAKS))
    want = np.asarray(jsd.dedupe_packed_device(jnp.asarray(packed)))
    got = tsd.dedupe_packed_device(torch.from_numpy(packed.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 40


# ---- the masked stretch -------------------------------------------------------


def _assert_matches_jax(got, want):
    assert got.iterations_run == want.iterations_run
    assert got.stars_masked == want.stars_masked
    assert got.converged == want.converged
    assert got.mask_coverage == pytest.approx(want.mask_coverage, abs=1e-9)
    assert abs(got.final_background - want.final_background) <= 1e-5
    out = got.image.numpy()
    np.testing.assert_allclose(out, np.asarray(want.image), atol=1e-4,
                               rtol=0)
    assert out.min() >= 0.0 and out.max() <= 1.0


@pytest.mark.parametrize("shape,n", [((256, 256), 60), ((128, 192), 25)])
def test_masked_stretch_fixed_iterations_matches_jax(shape, n):
    img = _field(*shape, n=n)
    cfg = dict(convergence_threshold=0.0)
    want = jms.masked_stretch(img, jms.MaskedStretchConfig(**cfg),
                              max_peaks=MAX_PEAKS)
    got = tms.masked_stretch(img, tms.MaskedStretchConfig(**cfg),
                             max_peaks=MAX_PEAKS, device=CPU)
    _assert_matches_jax(got, want)
    assert got.iterations_run == 10 and not got.converged
    assert got.final_background == pytest.approx(0.25, abs=0.02)


def test_masked_stretch_with_mask_matches_jax():
    """The MTF loop alone under one mask (JAX's), with the luminance
    protection off and a protection amount of 0.6."""
    img = _field(seed=4)
    jmask = jms.generate_star_mask(img, jms.StarMaskConfig())
    cfg = dict(convergence_threshold=0.0, iterations=6,
               protection_amount=0.6, target_background=0.2)
    want = jms.masked_stretch_with_mask(img, jmask,
                                        jms.MaskedStretchConfig(**cfg))
    tmask = tms.StarMaskResult(torch.from_numpy(np.array(jmask.mask)),
                               jmask.stars_masked, jmask.coverage_fraction)
    got = tms.masked_stretch_with_mask(img, tmask,
                                       tms.MaskedStretchConfig(**cfg),
                                       device=CPU)
    _assert_matches_jax(got, want)
    assert got.iterations_run == 6


def test_masked_stretch_small_plane_matches_jax():
    """rows < 3: no detection, an empty mask, the MTF loop alone."""
    img = np.random.default_rng(6).uniform(0.05, 0.3, (2, 50)) \
        .astype(np.float32)
    cfg = dict(convergence_threshold=0.0, iterations=4)
    want = jms.masked_stretch(img, jms.MaskedStretchConfig(**cfg))
    got = tms.masked_stretch(img, tms.MaskedStretchConfig(**cfg),
                             device=CPU)
    _assert_matches_jax(got, want)
    assert got.stars_masked == 0 and got.mask_coverage == 0.0


def _oracle_stretch(image, mask, cfg):
    """masked_stretch.rs:42-123 in numpy f32 with exact selection: the
    background is the element at sorted index cnt // 2 of the pixels
    with mask < 0.5, finite and > 0 (select_nth_unstable(len/2))."""
    f32 = np.float32
    valid = np.isfinite(image) & (image > f32(1e-7))
    dmin = image[valid].min() if valid.any() else f32(0)
    dmax = image[valid].max() if valid.any() else f32(0)
    rng = f32(dmax - dmin)
    with np.errstate(invalid="ignore"):
        work = np.where(np.isfinite(image) & (image > 0),
                        np.clip((image - dmin) / max(rng, f32(1e-30)), 0, 1),
                        f32(0)).astype(np.float32)
    if rng < 1e-10:
        work = np.zeros_like(image)
    blend = (mask * f32(cfg.protection_amount)).astype(np.float32)
    target, thr = f32(cfg.target_background), f32(cfg.convergence_threshold)

    def median(w):
        sel = w[(mask < 0.5) & np.isfinite(w) & (w > 0)]
        return np.partition(sel, len(sel) // 2)[len(sel) // 2] if len(sel) \
            else f32(0)

    prev, run, converged = f32(0), 0, False
    for it in range(cfg.iterations):
        bg = median(work)
        run = it + 1
        if abs(bg - target) < thr:
            converged = True
            break
        if it > 0 and abs(bg - prev) < thr * f32(0.1):
            break
        denom = f32(2) * target * bg - target - bg
        m = f32(0.5) if abs(denom) < 1e-15 else \
            np.clip(bg * (target - f32(1)) / denom, f32(1e-4), f32(0.9999))
        d = (f32(2) * m - f32(1)) * work - m
        small = np.abs(d) < 1e-10
        with np.errstate(divide="ignore", invalid="ignore"):
            val = np.clip((m - f32(1)) * work / np.where(small, f32(1), d),
                          0, 1)
        val = np.where(small, work, val)
        st = np.where(work <= 0, f32(0), np.where(work >= 1, f32(1), val))
        work = (work * blend + st * (f32(1) - blend)).astype(np.float32)
        prev = bg
    return np.clip(work, 0, 1), run, converged, median(work)


@pytest.mark.parametrize("seed,target", [(3, 0.25), (8, 0.15)])
def test_masked_stretch_default_threshold_matches_exact_oracle(seed, target):
    img = _field(seed=seed)
    cfg = tms.MaskedStretchConfig(target_background=target)
    got = tms.masked_stretch(img, cfg, max_peaks=MAX_PEAKS, device=CPU)
    # the port's own mask, rebuilt from its records for the oracle
    packed = tsd._detect(torch.from_numpy(img), 32, 5.0, MAX_PEAKS)
    xs, ys, radii, _ = tms._paint_records(packed, tms._mask_config(cfg))
    tmask, _ = _mask_kernel(torch.from_numpy(img), xs, ys, radii, 4.0, 0.85,
                            True)
    out, run, converged, final_bg = _oracle_stretch(img, tmask.numpy(), cfg)
    assert got.iterations_run == run and got.converged == converged
    assert 1 <= run < cfg.iterations
    assert got.final_background == float(final_bg)
    np.testing.assert_allclose(got.image.numpy(), out, atol=1e-6, rtol=0)


def test_masked_stretch_rgb_shared_matches_jax():
    rng = np.random.default_rng(12)
    base = _field(128, 128, n=20, seed=12)
    r, g, b = (np.clip(base * s + rng.normal(0, 0.002, base.shape), 0, None)
               .astype(np.float32) for s in (1.0, 0.8, 1.2))
    g[3, 5] = np.nan
    cfg = dict(convergence_threshold=0.0, iterations=5)
    want = jms.masked_stretch_rgb_shared(r, g, b,
                                         jms.MaskedStretchConfig(**cfg))
    got = tms.masked_stretch_rgb_shared(r, g, b,
                                        tms.MaskedStretchConfig(**cfg),
                                        device=CPU)
    assert got["shared_stars_masked"] == want["shared_stars_masked"] > 5
    assert got["shared_mask_coverage"] == pytest.approx(
        want["shared_mask_coverage"], abs=1e-9)
    for c in "rgb":
        _assert_matches_jax(got[c], want[c])
    lum = tms.synthesize_luminance(*(torch.from_numpy(a) for a in (r, g, b)))
    np.testing.assert_allclose(
        lum.numpy(), np.asarray(jms.synthesize_luminance(r, g, b)),
        rtol=1e-6, atol=0)
