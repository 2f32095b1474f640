"""PyTorch port: synthetic fixtures (``synth/star_field.py``,
``synth/psf.py``, ``synth/noise.py``, ``synth/pipeline.py``) against the
JAX package's on the CPU, at 64² to 128².

Tolerances, and why:

- star lists bit-equal (the same numpy draws);
- ``render_stars`` for each PSF within 1e-6 of the plane's largest
  value (the window sums and the PSF's exp/pow/J1 in another library),
  and bit-equal to a numpy oracle that paints the same per-star values
  one star at a time (the port sums each pixel in star order);
- the deterministic parts of the noise (``signal_electrons``,
  ``noise_transform`` on injected Poisson and normal draws,
  ``flat_from_uniform`` on injected uniform draws) bit-equal to numpy
  f32 in the same order, the flat within 1 ulp (torch's CPU ``sqrt``
  is one ulp off the correctly rounded one on some values, e.g.
  sqrt(534.5)); ``apply_flat_field`` bit-equal to JAX's;
- the noise itself against JAX's at the same ``NoiseParams``: torch
  cannot reproduce the ``jax.random`` streams (ROADMAP C29), so the
  mean and the variance of each output over a flat plane lie within
  5σ of each other (σ from the estimators' own spread);
- two runs with one seed bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu import synth as js
from astroburst_tpu.synth import noise as jnoise
from astroburst_tpu.synth import psf as jpsf
from astroburst_tpu_torch import synth as ts
from astroburst_tpu_torch.synth import noise as tnoise
from astroburst_tpu_torch.synth import pipeline as tpipe
from astroburst_tpu_torch.synth import psf as tpsf

torch.set_num_threads(1)
CPU = torch.device("cpu")
f32 = np.float32


def _stars_eq(a, b):
    assert [s.to_dict() for s in a] == [s.to_dict() for s in b]


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_star_fields_bit_equal(seed):
    cfg = dict(width=96, height=80, n_stars=40, seed=seed)
    _stars_eq(ts.uniform_field(ts.FieldConfig(**cfg)),
              js.uniform_field(js.FieldConfig(**cfg)))
    _stars_eq(ts.king_cluster(ts.FieldConfig(**cfg), 10.0, 60.0),
              js.king_cluster(js.FieldConfig(**cfg), 10.0, 60.0))
    _stars_eq(ts.exponential_disk(ts.FieldConfig(**cfg), 20.0, 60.0),
              js.exponential_disk(js.FieldConfig(**cfg), 20.0, 60.0))


PSFS = {"gaussian": (tpsf.GaussianPsf.from_fwhm(3.0),
                     jpsf.GaussianPsf.from_fwhm(3.0)),
        "moffat": (tpsf.MoffatPsf.from_fwhm(3.0, 2.5),
                   jpsf.MoffatPsf.from_fwhm(3.0, 2.5)),
        "airy": (tpsf.AiryPsf(2.0), jpsf.AiryPsf(2.0))}


def _stars(n=60, w=100, h=90, seed=3):
    stars = ts.uniform_field(ts.FieldConfig(w, h, n, seed=seed))
    # near and past every edge, and a pile-up on one pixel
    extra = [(0.2, 0.4), (w - 0.6, h - 0.3), (-3.0, 40.0), (w + 2.0, 10.0),
             (50.5, 44.5), (50.5, 44.5), (50.49, 44.51)]
    return stars + [ts.Star(x, y, 0.0, 1000.0 + i, 5000.0)
                    for i, (x, y) in enumerate(extra)]


def render_oracle(stars, tpsf_, width, height):
    """Star by star in numpy f32, each window's values taken from the
    port's own batch evaluation (so the order of the sums is what is
    tested): img[window] += vals · norm."""
    half = int(np.ceil(tpsf_.radius()))
    win = 2 * half + 1
    img = np.zeros((height + 2 * win, width + 2 * win), f32)
    for s in stars:
        sx, sy = f32(s.x), f32(s.y)
        y0 = min(max(int(np.round(sy)) - half + win, 0), height + win)
        x0 = min(max(int(np.round(sx)) - half + win, 0), width + win)
        py = (y0 + np.arange(win) - win).astype(f32)[:, None]
        px = (x0 + np.arange(win) - win).astype(f32)[None, :]
        d2 = (px - sx) ** 2 + (py - sy) ** 2
        vals = tpsf_.evaluate(torch.from_numpy(d2)).numpy()
        inside = (py >= 0) & (py <= height - 1) & (px >= 0) & \
            (px <= width - 1)
        vals = np.where(inside, vals, f32(0))
        total = torch.from_numpy(vals).sum().numpy()
        norm = f32(s.flux) / max(total, f32(1e-30)) if total > 1e-20 \
            else f32(0)
        img[y0:y0 + win, x0:x0 + win] += vals * f32(norm)
    return img[win:win + height, win:win + width]


@pytest.mark.parametrize("kind", ["gaussian", "moffat", "airy"])
def test_render_stars_matches_jax_and_oracle(kind):
    stars = _stars()
    tp, jp = PSFS[kind]
    got = tpsf.render_stars(stars, tp, 100, 90, CPU).numpy()
    want = np.asarray(jpsf.render_stars(stars, jp, 100, 90))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got, render_oracle(stars, tp, 100, 90))
    again = tpsf.render_stars(stars, tp, 100, 90, CPU).numpy()
    np.testing.assert_array_equal(got, again)


def test_render_no_stars_and_the_j1_polynomial():
    assert not tpsf.render_stars([], PSFS["airy"][0], 7, 5, CPU).any()
    x = np.linspace(-30.0, 30.0, 2001).astype(f32)
    got = tpsf._bessel_j1(torch.from_numpy(x)).numpy()
    want = np.asarray(jpsf._bessel_j1(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 4e-7


def test_noise_deterministic_parts_equal_numpy():
    rng = np.random.default_rng(5)
    img = (rng.random((40, 50)) * 300.0).astype(f32)
    p = ts.NoiseParams(gain=1.3, readout_noise=7.5, sky_background=150.0,
                       dark_current=0.04, exposure_time=120.0,
                       bias_level=900.0)
    sig = tnoise.signal_electrons(torch.from_numpy(img), p).numpy()
    want = np.maximum((img + f32(150.0)) * f32(1.3) * f32(120.0)
                      + f32(0.04) * f32(120.0), f32(0))
    np.testing.assert_array_equal(sig, want)
    photon = rng.poisson(want).astype(f32)
    normal = rng.normal(size=img.shape).astype(f32)
    got = tnoise.noise_transform(torch.from_numpy(photon),
                                 torch.from_numpy(normal), p).numpy()
    np.testing.assert_array_equal(got, np.maximum(
        (photon + normal * f32(7.5) + f32(900.0)) / f32(1.3), f32(0)))
    u = rng.random((33, 47)).astype(f32)
    flat = tnoise.flat_from_uniform(torch.from_numpy(u), 0.3).numpy()
    cx, cy = 47 * 0.5, 33 * 0.5
    r = np.sqrt((np.arange(47, dtype=f32)[None] - f32(cx)) ** 2
                + (np.arange(33, dtype=f32)[:, None] - f32(cy)) ** 2) \
        / np.sqrt(f32(cx * cx + cy * cy))
    want = np.maximum(
        (f32(1) - f32(0.3) * r * r) * (f32(1) + u * f32(0.02) - f32(0.01)),
        f32(0.01))
    assert np.abs(flat.view(np.int32) - want.view(np.int32)).max() <= 1
    img = img[:33, :47].copy()
    img[0, 0] = 5.0
    flat[0, 0] = 1e-7
    np.testing.assert_array_equal(
        tnoise.apply_flat_field(torch.from_numpy(img),
                                torch.from_numpy(flat)).numpy(),
        np.asarray(jnoise.apply_flat_field(jnp.asarray(img),
                                           jnp.asarray(flat))))


def _moments_close(a, b):
    n = a.size
    va, vb = a.var(dtype=np.float64), b.var(dtype=np.float64)
    assert abs(a.mean(dtype=np.float64) - b.mean(dtype=np.float64)) <= \
        5 * np.sqrt((va + vb) / n)
    assert abs(va - vb) <= 5 * np.sqrt(2.0 / (n - 1)) * np.hypot(va, vb)


@pytest.mark.parametrize("level", [0.0, 2.0, 40.0])
def test_noise_statistics_match_jax(level):
    img = np.full((128, 128), level, f32)
    for seed in (1, 123):
        p = dict(seed=seed)
        got = tnoise.apply_noise(torch.from_numpy(img),
                                 ts.NoiseParams(**p)).numpy()
        want = np.asarray(jnoise.apply_noise(img, js.NoiseParams(**p)))
        _moments_close(got, want)
        again = tnoise.apply_noise(torch.from_numpy(img),
                                   ts.NoiseParams(**p)).numpy()
        np.testing.assert_array_equal(got, again)
    u_t = tnoise.generate_flat_field(128, 96, 1122, 0.3, CPU).numpy()
    u_j = np.asarray(jnoise.generate_flat_field(128, 96, 1122, 0.3))
    _moments_close(u_t, u_j)


def _cfg(mod, **kw):
    return mod.SynthConfig(field=mod.FieldConfig(width=64, height=72,
                                                 n_stars=30, seed=9),
                           noise=mod.NoiseParams(seed=17), **kw)


@pytest.mark.parametrize("field_type", ["uniform", "king_cluster",
                                        "exponential_disk"])
@pytest.mark.parametrize("psf_type", ["gaussian", "moffat", "airy"])
def test_generate_matches_jax_and_repeats(field_type, psf_type):
    kw = dict(field_type=field_type, psf_type=psf_type, apply_vignette=True,
              core_radius=8.0, tidal_radius=40.0, scale_length=15.0)
    noisy, gt, stars = ts.generate(_cfg(ts, **kw), CPU)
    j_noisy, j_gt, j_stars = js.generate(_cfg(js, **kw))
    _stars_eq(stars, j_stars)
    w = np.asarray(j_gt)
    assert np.abs(gt.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    cfg = _cfg(ts, **kw)
    flat = tnoise.generate_flat_field(64, 72, 17 + 999, 0.3, CPU)
    want = tnoise.apply_noise(tnoise.apply_flat_field(gt, flat), cfg.noise)
    assert torch.equal(noisy, want)
    again = ts.generate(_cfg(ts, **kw), CPU)[0]
    assert torch.equal(noisy, again)
    assert noisy.shape == (72, 64) and np.asarray(j_noisy).shape == (72, 64)


def test_generate_stack_reseeds_each_frame():
    cfg = _cfg(ts, n_frames=3, apply_vignette=True)
    frames, gt, _ = ts.generate_stack(cfg, CPU)
    assert len(frames) == 3
    for i, fr in enumerate(frames):
        flat = tnoise.generate_flat_field(64, 72, 17 + 999 + i, 0.3, CPU)
        want = tnoise.apply_noise(
            tnoise.apply_flat_field(gt, flat),
            dataclasses.replace(cfg.noise, seed=17 + i * 7919))
        assert torch.equal(fr, want)
    assert not torch.equal(frames[0], frames[1])
    _, j_gt, _ = js.generate_stack(_cfg(js, n_frames=1))
    assert np.abs(gt.numpy() - np.asarray(j_gt)).max() <= \
        1e-6 * np.abs(np.asarray(j_gt)).max()


def test_save_catalog_equals_jax(tmp_path):
    stars = ts.king_cluster(ts.FieldConfig(64, 64, 12, seed=4), 8.0, 30.0)
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    tpipe.save_catalog(stars, str(a))
    js.save_catalog(js.king_cluster(js.FieldConfig(64, 64, 12, seed=4), 8.0,
                                    30.0), str(b))
    assert a.read_bytes() == b.read_bytes()
