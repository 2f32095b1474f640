"""PyTorch port: masters from FITS paths, the batch calibration pipeline
and the robust asinh preview against the JAX package
(astroburst_tpu/stacking/calibration.py, imaging/calibration_pipeline.py,
imaging/normalize.py), on the same seeded numpy inputs.

Tolerances, and why:

- ``sigma_clipped_mean_stack`` and the pipeline at
  ``normalize_before_stack=False``: bit-equal (NaN where NaN), rejected
  counts equal. Both packages sort the frame axis and select index
  cnt // 2 exactly (JAX: ``jnp.sort`` + a one-hot select,
  ``stacking/combine.py:38-59``; the port: ``torch.sort`` + gather),
  run the same f32 operations in the same order, and sum the
  survivors frame by frame.
- masters from FITS: bias and dark bit-equal (an exact median of the
  same f32 differences); the flat within rtol 1e-6 (its mean is a sum
  over the plane in another order, as tests/test_torch_calibration.py).
- the pipeline at ``normalize_before_stack=True``: each frame is
  divided by its mean, a sum over the plane that numpy, torch and XLA
  take in three orders (about 4e-7 relative apart), so a value within
  an ulp of a clip bound may flip. The masters agree within 1e-5
  absolute (they are min-max normalized to [0, 1]) except at most
  ``flip_bound`` pixels (chip_smoke.py: max(3, 1e-5 · frames ·
  pixels)); the per-frame rejected counts within as many; the channel
  mean and stddev within 1e-5 relative.
- ``robust_asinh_preview``: the port selects the ranks and the MAD
  exactly; against a numpy exact-selection oracle within 2 f32 ulp of
  the output (asinh in two libraries), against JAX (whose compare-count
  rank values are within range/8⁶ of the exact ones, ROADMAP C5)
  within the output's change for that input error: |d asinh(α(v−m)/σ)|
  ≤ α·δ(1 + range/σ)/σ for a rank error δ.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.imaging import calibration_pipeline as jcp
from astroburst_tpu.imaging.normalize import robust_asinh_preview as jrap
from astroburst_tpu.stacking import calibration as jcal
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging import calibration_pipeline as tcp
from astroburst_tpu_torch.imaging.normalize import robust_asinh_preview
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu_torch.stacking import calibration as tcal

torch.set_num_threads(1)

CPU = torch.device("cpu")
C5 = 8.0 ** -6


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def flip_bound(n_frames, npix):
    return max(3, int(1e-5 * n_frames * npix))


def _bad_stack(rng, n=5, h=48, w=64):
    """A noisy stack with NaN and ±inf values, outliers, a pixel NaN in
    every frame, one with inf in most frames, and a constant pixel
    (σ = 0: the σ < 1e-10 stop)."""
    s = rng.normal(100, 5, (n, h, w)).astype(np.float32)
    s[1, 3, 4] = np.nan
    s[2, 5, 6] = np.inf
    s[0, 7, 8] = -np.inf
    s[3, 9, 10] = 1e6
    s[rng.random(s.shape) < 0.02] = 400.0
    s[:, 20, 20] = np.nan
    s[: n - 2, 21, 21] = np.inf
    s[:, 22, 22] = 7.0
    s[:2, 23, 23] = np.nan      # cnt ≥ 3 but NaN sorts last
    return s


@pytest.mark.parametrize("sl,sh,iters", [(2.5, 3.0, 5), (1.0, 1.0, 5),
                                         (3.0, 3.0, 1), (0.5, 4.0, 8)])
def test_sigma_clipped_mean_stack_matches_jax(rng, sl, sh, iters):
    s = _bad_stack(rng)
    got, got_rej = tcp.sigma_clipped_mean_stack(_t(s), sl, sh, iters)
    want, want_rej = jcp.sigma_clipped_mean_stack(jnp.asarray(s), sl, sh,
                                                  iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_rej.tolist() == np.asarray(want_rej).tolist()
    assert got.dtype == torch.float32 and got_rej.shape == (5,)
    # NaN and inf take part: the all-NaN pixel stays NaN, inf stays inf
    assert np.isnan(got[20, 20].item()) and got[22, 22].item() == 7.0


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_sigma_clip_small_counts_match_jax(rng, n):
    """Fewer than 3 values leave a pixel inactive (its mean taken over
    every value); at 3 and 7 the clip runs."""
    s = rng.normal(10, 2, (n, 24, 40)).astype(np.float32)
    s[:, 0, :5] = 1e4
    got, got_rej = tcp.sigma_clipped_mean_stack(_t(s), 1.5, 1.5, 5)
    want, want_rej = jcp.sigma_clipped_mean_stack(jnp.asarray(s), 1.5, 1.5,
                                                  5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_rej.tolist() == np.asarray(want_rej).tolist()
    if n < 3:
        assert sum(got_rej.tolist()) == 0


def test_channel_and_frame_normalize_match_jax(rng):
    ch = rng.normal(3, 1, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tcp._normalize_channel(_t(ch)).numpy(),
        np.asarray(jcp._normalize_channel(jnp.asarray(ch))))
    flat = np.full((8, 9), 2.5, np.float32)
    assert tcp._normalize_channel(_t(flat)).abs().max().item() == 0.0
    for f in (ch, -np.abs(ch)):      # mean ≤ 0: the frame as it is
        got = tcp._mean_normalize_frame(_t(f)).numpy()
        want = np.asarray(jcp._mean_normalize_frame(jnp.asarray(f)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        tcp._mean_normalize_frame(_t(-np.abs(ch))).numpy(), -np.abs(ch))


def _cal_files(root, rng, h=56, w=72, n=4):
    """Raw bias/dark/flat frames of n each as FITS files; their arrays."""
    os.makedirs(root, exist_ok=True)
    yy = np.linspace(-1, 1, h)[:, None]
    xx = np.linspace(-1, 1, w)[None, :]
    bias = 500 + 2 * np.sin(40 * yy) + 0 * xx
    dark = 20 + np.zeros((h, w))
    dark[rng.integers(0, h, 9), rng.integers(0, w, 9)] += 800
    flat = 1 - 0.3 * (yy ** 2 + xx ** 2)
    frames = {
        "bias": [bias + rng.normal(0, 1.5, (h, w)) for _ in range(n)],
        "dark": [bias + dark + rng.normal(0, 1.5, (h, w))
                 for _ in range(n)],
        "flat": [bias + dark + 20000 * flat + rng.normal(0, 50, (h, w))
                 for _ in range(n)],
    }
    frames["bias"][1][4, 5] = np.nan        # a non-finite sample
    paths = {}
    for kind, fs in frames.items():
        paths[kind] = []
        for k, f in enumerate(fs):
            p = os.path.join(root, f"{kind}_{k}.fits")
            write_fits_mono(p, f.astype(np.float32),
                            HduHeader([("IMAGETYP", f"'{kind}'")]))
            paths[kind].append(p)
    return paths, (bias, dark, flat)


def test_masters_from_fits_paths_match_jax(tmp_path, rng):
    paths, _ = _cal_files(str(tmp_path), rng)
    mb = tcal.create_master_bias(paths["bias"], device=CPU)
    md = tcal.create_master_dark(paths["dark"], mb, device=CPU)
    mf = tcal.create_master_flat(paths["flat"], mb, md, device=CPU)
    jb = jcal.create_master_bias(paths["bias"])
    jd = jcal.create_master_dark(paths["dark"], jb)
    jf = jcal.create_master_flat(paths["flat"], jb, jd)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(md.numpy(), np.asarray(jd))
    np.testing.assert_allclose(mf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=0)
    # without the masters: the raw medians
    np.testing.assert_array_equal(
        tcal.create_master_dark(paths["dark"], device=CPU).numpy(),
        np.asarray(jcal.create_master_dark(paths["dark"])))
    np.testing.assert_allclose(
        tcal.create_master_flat(paths["flat"], device=CPU).numpy(),
        np.asarray(jcal.create_master_flat(paths["flat"])), rtol=1e-6,
        atol=0)
    # the image cache is not touched
    assert GLOBAL_IMAGE_CACHE.keys() == []


def test_master_errors_match_jax(tmp_path, rng):
    paths, _ = _cal_files(str(tmp_path), rng, n=2)
    odd = str(tmp_path / "odd.fits")
    write_fits_mono(odd, np.ones((30, 72), np.float32))
    for tfn, jfn, msg in ((tcal.create_master_bias, jcal.create_master_bias,
                           "No bias frames provided"),
                          (tcal.create_master_dark, jcal.create_master_dark,
                           "No dark frames provided"),
                          (tcal.create_master_flat, jcal.create_master_flat,
                           "No flat frames provided")):
        with pytest.raises(InvalidInput, match=msg):
            tfn([], device=CPU)
        with pytest.raises(Exception, match=msg):
            jfn([])
        bad = paths["bias"] + [odd]
        with pytest.raises(InvalidInput) as got:
            tfn(bad, device=CPU)
        with pytest.raises(Exception) as want:
            jfn(bad)
        assert str(got.value) == str(want.value)
        assert "Dimension mismatch: expected (56, 72), got (30, 72)" in \
            str(got.value) and odd in str(got.value)


def _lights(rng, n=5, h=56, w=72, masters=None):
    """n raw lights of a star field (bias + dark + flat · sky) with NaN
    and hot pixels and a satellite trail in frame 2."""
    bias, dark, flat = masters if masters is not None else (0.0, 0.0, 1.0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    sky = np.full((h, w), 300.0)
    for _ in range(12):
        cy, cx, a = rng.uniform(4, h - 4), rng.uniform(4, w - 4), \
            rng.uniform(200, 3000)
        sky += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
    out = []
    for k in range(n):
        f = bias + dark + flat * sky + rng.normal(0, 5, (h, w))
        if k == 2:
            f[10, :] += 5000.0
        out.append(f.astype(np.float32))
    out[1][3, 3] = np.nan
    out[-1][6, 7] = np.inf
    return out


def _run_both(lights_by_ch, masters_np, normalize, **kw):
    tm = tcal.CalibrationConfig(*(None if m is None else _t(m)
                                  for m in masters_np))
    jm = jcal.CalibrationConfig(*(None if m is None else jnp.asarray(m)
                                  for m in masters_np))
    got = tcp.run_batch_pipeline(
        [tcp.ChannelInput(lbl, [_t(f) for f in fs])
         for lbl, fs in lights_by_ch],
        tm, tcp.BatchStackConfig(normalize_before_stack=normalize, **kw))
    want = jcp.run_batch_pipeline(
        [jcp.ChannelInput(lbl, [jnp.asarray(f) for f in fs])
         for lbl, fs in lights_by_ch],
        jm, jcp.BatchStackConfig(normalize_before_stack=normalize, **kw))
    return got, want


@pytest.mark.parametrize("normalize", [False, True])
def test_run_batch_pipeline_matches_jax(rng, normalize):
    h, w = 56, 72
    bias = rng.normal(500, 2, (h, w)).astype(np.float32)
    dark = rng.normal(20, 1, (h, w)).astype(np.float32)
    flat = rng.uniform(0.7, 1.1, (h, w)).astype(np.float32)
    chans = [(lbl, _lights(rng, masters=(bias, dark, flat)))
             for lbl in ("R", "G", "B")]
    got, want = _run_both(chans, (bias, dark, flat), normalize,
                          sigma_low=2.0, sigma_high=2.5)
    assert [lbl for lbl, _ in got.master_channels] == ["R", "G", "B"]
    assert set(got.stats) == set(want.stats)
    for k in ("bias_combined", "darks_combined", "flats_combined"):
        assert got.stats[k] == want.stats[k] == 1
    bound = flip_bound(5, h * w)
    for (lbl, m), (_, jm), gs, js in zip(got.master_channels,
                                         want.master_channels,
                                         got.stats["channels"],
                                         want.stats["channels"]):
        m, jm = m.numpy(), np.asarray(jm)
        assert set(gs) == set(js) == {"label", "lights_input",
                                      "lights_after_rejection", "mean",
                                      "stddev"}
        assert gs["label"] == lbl and gs["lights_input"] == 5
        if not normalize:
            np.testing.assert_array_equal(m, jm)
            assert gs == js
        else:
            assert int((np.abs(m - jm) > 1e-5).sum()) <= bound
            assert max(abs(a - b) for a, b in zip(
                gs["lights_after_rejection"],
                js["lights_after_rejection"])) <= bound
            for k in ("mean", "stddev"):
                assert gs[k] == pytest.approx(js[k], rel=1e-5)
        # stddev is numpy's population figure of the f32 master
        assert gs["stddev"] == float(m.std())
        assert sum(gs["lights_after_rejection"]) > 0   # the trail
    np.testing.assert_array_equal(
        got.rgb.numpy(), np.stack([m.numpy() for _, m in
                                   got.master_channels]))


def test_run_batch_pipeline_without_masters_and_errors(rng):
    chans = [("L", _lights(rng, n=4)), ("Ha", _lights(rng, n=3))]
    got, want = _run_both(chans, (None, None, None), False)
    assert got.rgb is None and want.rgb is None
    for (_, m), (_, jm) in zip(got.master_channels, want.master_channels):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert got.stats == want.stats
    assert got.stats["bias_combined"] == 0
    with pytest.raises(InvalidInput, match="No channels provided"):
        tcp.run_batch_pipeline([])
    with pytest.raises(InvalidInput, match="Channel 'X' has no light"):
        tcp.run_batch_pipeline([tcp.ChannelInput("X", [])])


def test_run_batch_pipeline_three_shapes_make_no_rgb(rng):
    chans = [("R", _lights(rng, n=3)), ("G", _lights(rng, n=3)),
             ("B", _lights(rng, n=3, h=40))]
    got, want = _run_both(chans, (None, None, None), False)
    assert got.rgb is None and want.rgb is None


def _asinh_oracle(x):
    """Exact-selection numpy oracle of robust_asinh_preview in f32."""
    flat = x.reshape(-1)
    valid = np.isfinite(flat) & (flat > 1e-7)
    vals = np.sort(flat[valid])
    n = np.float32(vals.size)
    mid = int(np.floor(n / np.float32(2)))
    lo = int(np.floor(n * np.float32(0.01)))
    hi = int(min(np.floor(n * np.float32(0.999)), n - 1))
    med = vals[mid]
    mad = np.sort(np.abs(vals - med))[mid]
    sigma = max(np.float32(mad * np.float32(1.4826)), np.float32(1e-10))
    scaled = (np.float32(10.0) / sigma) * (np.clip(x, vals[lo], vals[hi])
                                           - med)
    out = np.arcsinh(scaled.astype(np.float32))
    keep = np.isfinite(x) & (x > 1e-7)
    return np.where(keep, out, np.float32(0)).astype(np.float32), sigma, \
        vals[-1] - vals[0]


@pytest.mark.parametrize("case", ["noise", "stars", "padded"])
def test_robust_asinh_preview_matches_oracle_and_jax(rng, case):
    x = rng.normal(1.0, 0.1, (64, 80)).astype(np.float32)
    if case == "stars":
        x[rng.random(x.shape) < 0.01] += 50.0
    if case == "padded":
        x[:, :12] = 0.0
        x[5, 5] = np.nan
        x[6, 6] = -np.inf
        x[7, 7] = np.inf
    got = robust_asinh_preview(_t(x)).numpy()
    want, sigma, rng_ = _asinh_oracle(x)
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
    j = np.asarray(jrap(jnp.asarray(x)))
    delta = rng_ * C5
    tol = 10.0 * delta * (1.0 + rng_ / sigma) / sigma + 2 * ulp
    np.testing.assert_allclose(got, j, atol=tol, rtol=0)


def test_robust_asinh_preview_without_valid_pixels():
    x = np.zeros((6, 7), np.float32)
    x[0, 0] = np.nan
    got = robust_asinh_preview(_t(x)).numpy()
    want = np.asarray(jrap(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
