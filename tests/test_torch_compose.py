"""PyTorch port: the compose modules (``compose/white_balance``,
``channel_blend``, ``lrgb``, ``rgb``, ``drizzle_rgb``) against the JAX
package's (astroburst_tpu/compose/) and against numpy f32 oracles, on
seeded numpy planes (128² to 256²).

Tolerances, and why:

- white balance, dimension info, channel synthesis ((a + b) · 0.5) and
  the ratio cap: equal (host f64 math, or one exactly rounded op);
- the blend, the luminance, LRGB and the STF: bit-equal to numpy f32
  oracles that round every operation in the port's order; against JAX
  within the FMA contraction XLA makes on the CPU (ROADMAP C13, C19,
  C25): the blend within n_channels ulp of Σ|w·x|, the luminance and
  LRGB within 8 ulp of 1 (their outputs lie in [0, 1] where not dark),
  the STF within 8 ulp of 1 times (1 + the MTF's slope at the pixel);
- phase-correlation offsets: within 0.05 px of JAX's under
  ``jax_parabola_vertex`` (C8; the bound of
  tests/test_torch_phase_correlation.py: the whitened cross-power
  amplifies the two FFTs' rounding where a resampled channel has no
  power; on unresampled channels they agree to ~1e-7 px) and 0.2 px of
  the generator (the 3-point parabola is biased on these stars);
  affine transforms within 1e-3 (tests/test_torch_affine.py's bound:
  centroids sum in another order);
- ``process_rgb``: the port bit-equal to a numpy oracle of the pipeline
  given its own aligned planes and stats. Against JAX, everything moves
  with two measured differences: the offsets' (a plane moves by it
  times its largest one-pixel change) and the white-balance factors',
  which are ratios of medians (C5: JAX's compare-count medians lie
  within range/8⁶ of the exact ones). So: stats within those moves
  plus range/8⁶ (median, MAD); the STF parameters within 1e-4; the
  pre-stretch planes within them plus 1e-6 of their largest magnitude
  (1e-4 after the affine route: JAX warps by its shear form, the port
  by the direct sampler, the bound of
  test_warp_image_matches_jax_direct_sampler); the stretched planes
  within the normalised input's change (planes, min, range, shadow)
  times the MTF's steepest slope between the two, plus 5e-4 for the
  midtone's change, ×4 after SCNR;
- ``process_drizzle_rgb`` and ``drizzle_rgb``: as ``process_rgb``; the
  two mean-of-three forms, (r + g + b) · (1/3) in ``rgb`` and
  (r + g + b) / 3 in ``drizzle_rgb`` (they differ by an ulp on about a
  third of the pixels; XLA compiles both to the multiply, C27), each
  held bit-equal to its numpy form by the linked cases' oracles.
"""

import math

import numpy as np
import pytest
import torch

from astroburst_tpu import dtypes as jd
from astroburst_tpu.alignment import affine as ja
from astroburst_tpu.compose import channel_blend as jblend
from astroburst_tpu.compose import drizzle_rgb as jdrz
from astroburst_tpu.compose import lrgb as jlrgb
from astroburst_tpu.compose import rgb as jrgb
from astroburst_tpu.compose import white_balance as jwb
from astroburst_tpu.errors import InvalidInput as JInvalidInput
from astroburst_tpu_torch import dtypes as td
from astroburst_tpu_torch.alignment import affine as ta
from astroburst_tpu_torch.alignment.pair import shift_image_subpixel
from astroburst_tpu_torch.compose import channel_blend as tblend
from astroburst_tpu_torch.compose import drizzle_rgb as tdrz
from astroburst_tpu_torch.compose import lrgb as tlrgb
from astroburst_tpu_torch.compose import rgb as trgb
from astroburst_tpu_torch.compose import white_balance as twb
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.imaging.resample import resample_image
from tests.reference_impl import ref_apply_scnr
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ULP1 = float(np.spacing(np.float32(1.0)))
RES = 8.0 ** 6
F = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def star_rgb(h=160, w=160, shifts=((1.3, -2.4), (-3.7, 0.6)),
             scales=(1.0, 0.8, 1.2), seed=1, n=30):
    """Three channels of one field of Gaussian stars (FWHM ~4 px) on a
    0.1 background, G and B moved by ``shifts`` (dy, dx) and scaled."""
    rng = np.random.default_rng(seed)
    ys, xs = rng.uniform(10, h - 10, n), rng.uniform(10, w - 10, n)
    amps = rng.uniform(0.2, 0.8, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for k, ((dy, dx), s) in enumerate(zip(((0.0, 0.0),) + tuple(shifts),
                                          scales)):
        img = np.full((h, w), 0.1)
        for cy, cx, a in zip(ys, xs, amps):
            img += a * np.exp(-((yy - cy - dy) ** 2 + (xx - cx - dx) ** 2)
                              / (2 * 1.8 ** 2))
        img += np.random.default_rng(seed * 10 + k).normal(0, 0.003, (h, w))
        out.append((img * s).astype(np.float32))
    return out


def affine_rgb(deg=0.4, shift=(2.6, -1.8), hw=256, seed=11):
    """A 256² star field (tests/test_affine.py's) in [0, 1], G rotated
    by ``deg`` about the centre and B shifted, by JAX's exact warp."""
    rng = np.random.default_rng(seed)
    img = rng.normal(50.0, 1.5, (hw, hw))
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    for x, y in rng.random((40, 2)) * (hw - 40) + 20:
        img += (300 + rng.random() * 700) * np.exp(
            -((yy - y) ** 2 + (xx - x) ** 2) / (2 * 1.6 ** 2))
    img = (img / 1100.0).astype(np.float32)
    c = hw / 2.0
    th = math.radians(deg)
    ct, st = math.cos(th), math.sin(th)
    rot = ja.AffineTransform(a=ct, b=st, tx=c - ct * c - st * c,
                             c=-st, d=ct, ty=c + st * c - ct * c)
    g = np.asarray(ja.warp_image(img, rot, hw, hw, exact=True))
    b = np.asarray(ja.warp_image(img, ja.AffineTransform(
        tx=-shift[1], ty=-shift[0]), hw, hw, exact=True))
    return [img, (0.9 * g).astype(np.float32), (1.1 * b).astype(np.float32)]


# ---- numpy f32 oracles (every operation rounded, the port's order) ---------


def np_stf(x, params, stats):
    """apply_stf_f32 / apply_stf_composite in f32."""
    rng = max(stats.max - stats.min, 1e-30)
    clip = max(params.highlight - params.shadow, 1e-15)
    dmin, inv_r, sh, inv_c, m = (F(v) for v in (
        stats.min, 1.0 / rng, params.shadow, 1.0 / clip, params.midtone))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        norm = (x - dmin) * inv_r
        c = np.clip((norm - sh) * inv_c, F(0), F(1))
        denom = (F(2) * m - F(1)) * c - m
        s = (m - F(1)) * c / denom
        s = np.where(c <= 0, F(0), np.where(c >= 1, F(1), s))
        valid = np.isfinite(x) & (x > F(1e-7))
    return np.where(valid, s, F(0)).astype(np.float32)


def mtf_slope(x, params, stats):
    """|d stf / d c| at each pixel, f64 (the conditioning of the STF)."""
    rng = max(stats.max - stats.min, 1e-30)
    clip = max(params.highlight - params.shadow, 1e-15)
    with np.errstate(invalid="ignore"):
        c = np.clip(((x.astype(np.float64) - stats.min) / rng
                     - params.shadow) / clip, 0.0, 1.0)
    m = params.midtone
    slope = m * (1.0 - m) / ((2.0 * m - 1.0) * c - m) ** 2 / clip
    return np.where(np.isfinite(slope), slope, 0.0)


def np_lum(r, g, b):
    return F(0.2126) * r + F(0.7152) * g + F(0.0722) * b


def np_lrgb(l, r, g, b, lw, cw):
    lw, cw = F(lw), F(cw)
    lum_old = r * F(0.2126) + g * F(0.7152) + b * F(0.0722)
    dark = lum_old < F(1e-10)
    blended = l * lw
    with np.errstate(invalid="ignore", over="ignore"):
        ratio = (l * lw + lum_old * (F(1) - lw)) / np.where(dark, F(1),
                                                            lum_old)
        l_part = l * (F(1) - cw)
        return tuple(np.where(dark, blended, np.clip(
            ch * ratio * cw + l_part, F(0), F(1))).astype(np.float32)
            for ch in (r, g, b))


def np_blend(planes, w):
    out = []
    for c in range(3):
        acc = planes[0] * w[0, c]
        for k in range(1, len(planes)):
            acc = acc + planes[k] * w[k, c]
        out.append(acc.astype(np.float32))
    return out


def _stats_close(got, want, what="", rel=0.0, extra=0.0):
    """Stats of planes that differ by at most ``rel`` of each value plus
    ``extra``: min and max by that, the median and the MAD also by the
    compare-count error (C5), the mean also by its sum order."""
    rng = max(want.max - want.min, 1e-30)
    assert got.valid_count == want.valid_count, what
    for k in ("min", "max", "median", "mad", "mean"):
        g_, w_ = getattr(got, k), getattr(want, k)
        tol = rel * abs(w_) + extra + 1e-6 * rng + (
            4 * rng / RES if k in ("median", "mad") else 0.0)
        assert abs(g_ - w_) <= tol, (what, k, g_, w_, tol)


def _stf_close(got, want):
    assert got.highlight == want.highlight
    assert abs(got.shadow - want.shadow) <= 1e-4
    assert abs(got.midtone - want.midtone) <= 1e-4


def _jstats(s):
    return jd.ImageStats(**{k: getattr(s, k) for k in (
        "min", "max", "median", "mad", "sigma", "mean", "valid_count")})


# ---- white balance ----------------------------------------------------------


WB_CASES = {
    "r_stable": ((0.1, 0.001), (0.2, 0.01), (0.3, 0.02)),
    "g_stable": ((0.1, 0.01), (0.2, 0.001), (0.3, 0.02)),
    "b_stable": ((0.1, 0.01), (0.2, 0.02), (0.3, 0.001)),
    "ties": ((0.1, 0.01), (0.2, 0.02), (0.3, 0.03)),
    "g_b_tie": ((0.1, 0.05), (0.2, 0.02), (0.3, 0.03)),
    "dark_median": ((1e-12, 0.01), (0.2, 0.02), (0.0, 0.0)),
}


@pytest.mark.parametrize("case", sorted(WB_CASES))
def test_select_wb_reference_equals_jax(case):
    ts = [td.ImageStats(median=m, mad=d, valid_count=9)
          for m, d in WB_CASES[case]]
    assert twb.select_wb_reference(*ts) == jwb.select_wb_reference(
        *[_jstats(s) for s in ts])


# ---- the blend --------------------------------------------------------------


BLEND_WEIGHTS = {
    "sho": [dict(channel_idx=0, r_weight=1.0, g_weight=0.0, b_weight=0.0),
            dict(channel_idx=1, r_weight=0.0, g_weight=1.0, b_weight=0.0),
            dict(channel_idx=2, r_weight=0.0, g_weight=0.0, b_weight=1.0)],
    "hubble_legacy_and_repeat": [
        dict(channel_idx=0, r_weight=0.7, g_weight=0.3, b_weight=0.0),
        dict(channel_idx=1, r_weight=0.3, g_weight=0.8, b_weight=0.2),
        dict(channel_idx=2, r_weight=0.0, g_weight=0.15, b_weight=0.85),
        dict(channel_idx=1, r_weight=0.1, g_weight=-0.2, b_weight=0.05)],
    "out_of_range_ignored": [
        dict(channel_idx=3, r_weight=0.9, g_weight=0.4, b_weight=0.0),
        dict(channel_idx=7, r_weight=5.0, g_weight=5.0, b_weight=5.0),
        dict(channel_idx=0, r_weight=0.1, g_weight=0.6, b_weight=1.0)],
}


@pytest.mark.parametrize("case", sorted(BLEND_WEIGHTS))
@pytest.mark.parametrize("n", [1, 4])
def test_blend_channels_matches_oracle_and_jax(case, n):
    rng = np.random.default_rng(n)
    planes = [rng.uniform(0.0, 2.0, (64, 72)).astype(np.float32)
              for _ in range(n)]
    planes[0][5, 6] = np.nan
    weights = BLEND_WEIGHTS[case]
    got = tblend.blend_channels([_t(p) for p in planes], weights)
    w = tblend.blend_weights(n, weights)
    assert w.shape == (n, 3)
    for k in range(n):   # out-of-range indices ignored, repeats summed
        for c, key in enumerate(("r_weight", "g_weight", "b_weight")):
            assert w[k, c] == np.float32(sum(
                np.float32(e[key]) for e in weights
                if e["channel_idx"] == k))
    for g_, o in zip(got, np_blend(planes, w)):
        np.testing.assert_array_equal(g_.numpy(), o)
    want = jblend.blend_channels(planes, weights)
    mag = sum(np.abs(p[..., None] * w[k]) for k, p in enumerate(planes))
    for c, (g_, j) in enumerate(zip(got, want)):
        j = np.asarray(j)
        np.testing.assert_array_equal(np.isnan(g_.numpy()), np.isnan(j))
        fin = np.isfinite(j)
        assert (np.abs(g_.numpy() - j)[fin]
                <= n * ULP1 * mag[..., c][fin] + 1e-30).all()


# ---- luminance and LRGB -----------------------------------------------------


def _lrgb_planes(rng, shape=(48, 56)):
    r, g, b, l = (rng.uniform(0.0, 1.0, shape).astype(np.float32)
                  for _ in range(4))
    r[:4, :4] = g[:4, :4] = b[:4, :4] = 0.0     # dark pixels
    r[10, 10] = np.nan
    l[11, 11] = 1.7                              # dark/bright beyond 1
    r[:2, :2] = 0.0
    return l, r, g, b


def test_synthesize_luminance_matches_oracle_and_jax():
    _, r, g, b = _lrgb_planes(np.random.default_rng(3))
    got = tlrgb.synthesize_luminance(_t(r), _t(g), _t(b)).numpy()
    np.testing.assert_array_equal(got, np_lum(r, g, b))
    want = np.asarray(jlrgb.synthesize_luminance(r, g, b))
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * ULP1)


@pytest.mark.parametrize("lw,cw", [(1.0, 1.0), (0.6, 0.8), (0.0, 0.3),
                                   (1.4, 0.0)])
def test_apply_lrgb_matches_oracle_and_jax(lw, cw):
    l, r, g, b = _lrgb_planes(np.random.default_rng(4))
    got = tlrgb.apply_lrgb(_t(l), _t(r), _t(g), _t(b), lw, cw)
    want = jlrgb.apply_lrgb(l, r, g, b, lw, cw)
    dark = np_lum(r, g, b) < F(1e-10)
    assert dark[:4, :4].all()
    for got_c, ora, j in zip(got, np_lrgb(l, r, g, b, lw, cw), want):
        got_c, j = got_c.numpy(), np.asarray(j)
        np.testing.assert_array_equal(got_c, ora)
        # dark pixels: l · lightness unclipped, in both packages
        np.testing.assert_array_equal(got_c[dark], (l * F(lw))[dark])
        np.testing.assert_array_equal(got_c[dark], j[dark])
        np.testing.assert_array_equal(np.isnan(got_c), np.isnan(j))
        np.testing.assert_allclose(got_c, j, rtol=0, atol=8 * ULP1)
    with pytest.raises(InvalidInput):
        tlrgb.apply_lrgb(_t(l[:40]), _t(r), _t(g), _t(b))
    with pytest.raises(JInvalidInput):
        jlrgb.apply_lrgb(l[:40], r, g, b)


# ---- the composite STF ------------------------------------------------------


@pytest.mark.parametrize("midtone", [None, 0.9999, 0.5])
def test_composite_stf_matches_oracle_and_jax(midtone):
    """The composite's STF (JAX's apply_stf_composite) is the port's
    apply_stf_f32: the same validity rule and parameter scalars."""
    r, _, _ = star_rgb(96, 96)
    r[3, 3], r[4, 4], r[5, 5], r[6, 6] = np.nan, np.inf, 0.0, 1e-7
    stats = trgb.compute_image_stats(_t(r))
    params = trgb.auto_stf(stats)
    if midtone is not None:
        params = td.StfParams(params.shadow, midtone, 1.0)
    got = trgb.apply_stf_f32(_t(r), params, stats).numpy()
    np.testing.assert_array_equal(got, np_stf(r, params, stats))
    assert (got[3:7, 3:7].diagonal() == 0.0).all()
    want = np.asarray(jrgb.apply_stf_composite(
        r, jd.StfParams(params.shadow, params.midtone, params.highlight),
        _jstats(stats)))
    bound = 8 * ULP1 * (1.0 + mtf_slope(r, params, stats))
    assert (np.abs(got - want) <= bound).all()


# ---- dimensions and synthesis -----------------------------------------------


def test_harmonize_dimensions_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    g = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    b = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    got = trgb.harmonize_dimensions(_t(r), _t(g), None)
    want = jrgb.harmonize_dimensions(r, g, None)
    assert got[2] is None and want[2] is None
    assert got[3:5] == want[3:5] == (96, 128)
    assert got[5].to_dict() == want[5].to_dict() == {
        "original_r": (128, 96), "original_g": (64, 48),
        "original_b": None, "target": (128, 96), "resampled": True}
    assert torch.equal(got[0], _t(r))
    assert torch.equal(got[1], resample_image(_t(g), 96, 128))
    # the resize: C19, 2 ulp of the plane's largest magnitude
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=2 * ULP1 * float(np.abs(g).max()))
    same = trgb.harmonize_dimensions(_t(r), _t(b), _t(r))
    assert same[3:] == (96, 128, None) and same[0] is not None
    assert trgb.harmonize_dimensions(None, None, None)[3:] == (0, 0, None)


@pytest.mark.parametrize("small", [(11, 16), (12, 16)])
def test_ratio_cap_raises_in_both(small):
    big = np.ones((96, 128), np.float32)
    tiny = np.ones(small, np.float32)
    ratio = max(96 / small[0], 128 / small[1])
    if ratio > 8.0:
        with pytest.raises(InvalidInput, match="exceeds"):
            trgb.harmonize_dimensions(_t(big), _t(tiny), None)
        with pytest.raises(JInvalidInput, match="exceeds"):
            jrgb.harmonize_dimensions(big, tiny, None)
    else:
        assert trgb.harmonize_dimensions(_t(big), _t(tiny), None)[5] \
            .resampled


@pytest.mark.parametrize("present", ["rgb", "rg", "rb", "gb", "r", ""])
def test_channel_or_synth_equals_jax(present):
    rng = np.random.default_rng(6)
    planes = {c: rng.uniform(0, 1, (8, 9)).astype(np.float32) for c in "rgb"}
    t = {c: (_t(planes[c]) if c in present else None) for c in "rgb"}
    j = {c: (planes[c] if c in present else None) for c in "rgb"}
    for p, a1, a2 in (("r", "g", "b"), ("g", "r", "b"), ("b", "r", "g")):
        got = trgb.channel_or_synth(t[p], t[a1], t[a2], 8, 9)
        want = jrgb.channel_or_synth(j[p], j[a1], j[a2], 8, 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- alignment ----------------------------------------------------------------


def test_align_rgb_channels_phase_correlation_matches_jax():
    r, g, b = star_rgb()
    got = trgb.align_rgb_channels(_t(r), _t(g), _t(b), 160, 160,
                                  td.AlignMethod.PHASE_CORRELATION)
    want = jrgb.align_rgb_channels(r, g, b, 160, 160,
                                   jd.AlignMethod.PHASE_CORRELATION)
    for k, truth in ((3, (1.3, -2.4)), (4, (-3.7, 0.6))):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
        # the 3-point parabola of the peak is biased on these stars
        np.testing.assert_allclose(got[k], truth, rtol=0, atol=0.2)
    assert torch.equal(got[0], _t(r))
    for k, src in ((1, g), (2, b)):
        dy, dx = got[k + 2]
        assert torch.equal(got[k], shift_image_subpixel(_t(src), dy, dx))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5 * float(src.max()))


def test_align_rgb_channels_affine_matches_jax():
    r, g, b = affine_rgb()
    got = trgb.align_rgb_channels(_t(r), _t(g), _t(b), 256, 256,
                                  td.AlignMethod.AFFINE)
    want = jrgb.align_rgb_channels(r, g, b, 256, 256, jd.AlignMethod.AFFINE)
    for k in (3, 4):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[4], (2.6, -1.8), atol=0.1)
    for k, src in ((1, g), (2, b)):
        res = ta.align_channel_affine(_t(r), _t(src))
        assert res.method in ("affine", "rigid")
        assert torch.equal(got[k], ta.warp_image(_t(src), res.transform,
                                                 256, 256))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4 * float(src.max()))
    rot = ta.align_channel_affine(_t(r), _t(g)).transform.rotation_deg()
    assert abs(abs(rot) - 0.4) < 0.1


# ---- process_rgb ----------------------------------------------------------------


def _oracle_rgb(got, config, aligned):
    """The pipeline after alignment in numpy f32, from the port's own
    aligned planes and stats: white balance, STF, SCNR."""
    wb = _factors(config, (got.stats_r, got.stats_g, got.stats_b))
    pre = [a if abs(m - 1.0) < 1e-7 else a * F(m)
           for a, m in zip(aligned, wb)]
    if config.auto_stretch and config.linked_stf:
        merged = (pre[0] + pre[1] + pre[2]) * F(1.0 / 3.0)
        linked = trgb.auto_stf(trgb.compute_image_stats(_t(merged)),
                               config.auto_stf)
        params = [linked] * 3
    elif config.auto_stretch:
        params = [trgb.auto_stf(s, config.auto_stf)
                  for s in (got.stats_wb_r, got.stats_wb_g, got.stats_wb_b)]
    else:
        ident = td.StfParams()
        params = [config.stf_r or ident, config.stf_g or ident,
                  config.stf_b or ident]
    out = [np_stf(p, q, s) for p, q, s in zip(
        pre, params, (got.stats_wb_r, got.stats_wb_g, got.stats_wb_b))]
    if config.scnr is not None:
        out = ref_apply_scnr(*out, "average_neutral"
                             if config.scnr.method.value == "average"
                             else "maximum_neutral", config.scnr.amount,
                             config.scnr.preserve_luminance)
    return pre, params, out


def _stretched_close(out, jout, p, jp, params, stats, jparams, jstats,
                     scnr):
    """Stretched planes against JAX's: the change of the normalised
    input (the planes' difference, and the min and range of their stats)
    and of the shadow, through the MTF's steepest slope between the two
    (the slope is monotone in c), plus 5e-4 for the midtone's change;
    four times that after SCNR (its luminance boost moves R and B by
    2.5 δG)."""
    rng = max(stats.max - stats.min, 1e-30)
    slope = np.maximum(mtf_slope(p, params, stats),
                       mtf_slope(jp, params, stats))
    fin = np.isfinite(p) & np.isfinite(jp)
    d_norm = (np.where(fin, np.abs(p - jp), 0.0) + abs(stats.min - jstats.min)
              + abs(rng - (jstats.max - jstats.min))) / rng
    d_norm = d_norm + abs(params.shadow - jparams.shadow)
    bound = (5e-4 + 1.01 * slope * d_norm) * (4.0 if scnr else 1.0)
    assert (np.abs(out - jout) <= bound).all()


def _factors(config, stats):
    mode = config.white_balance.mode
    if mode == td.WhiteBalanceMode.AUTO:
        return twb.select_wb_reference(*stats)
    if mode == td.WhiteBalanceMode.MANUAL:
        return (config.white_balance.r, config.white_balance.g,
                config.white_balance.b)
    return (1.0, 1.0, 1.0)


def _grad_max(plane):
    """The largest change of a plane over one pixel (finite pixels)."""
    d = [np.abs(np.diff(plane, axis=k)) for k in (0, 1)]
    return max(float(np.nanmax(np.where(np.isfinite(x), x, np.nan)))
               for x in d)


def _configs(case):
    scnr = dict(method=td.ScnrMethod.MAXIMUM_NEUTRAL, amount=0.7,
                preserve_luminance=True)
    wb = {"auto": {}, "none": dict(mode=td.WhiteBalanceMode.NONE),
          "manual": dict(mode=td.WhiteBalanceMode.MANUAL, r=1.1, g=0.9,
                         b=1.3)}[case.get("wb", "auto")]
    kw = dict(linked_stf=case.get("linked", True),
              auto_stretch=case.get("auto_stretch", True),
              align=case.get("align", True),
              align_method=td.AlignMethod(case.get("method",
                                                   "phase_correlation")))
    if not kw["auto_stretch"]:
        kw["stf_r"] = td.StfParams(0.05, 0.2, 1.0)
    t = td.RgbComposeConfig(
        white_balance=td.WhiteBalance(**wb),
        scnr=td.ScnrConfig(**scnr) if case.get("scnr") else None, **kw)

    def jconv(v):
        if isinstance(v, td.StfParams):
            return jd.StfParams(v.shadow, v.midtone, v.highlight)
        if isinstance(v, td.AlignMethod):
            return jd.AlignMethod(v.value)
        return v

    j = jd.RgbComposeConfig(
        white_balance=jd.WhiteBalance(**{k: (jd.WhiteBalanceMode(v.value)
                                             if k == "mode" else v)
                                         for k, v in wb.items()}),
        scnr=jd.ScnrConfig(jd.ScnrMethod.MAXIMUM_NEUTRAL, 0.7, True)
        if case.get("scnr") else None,
        **{k: jconv(v) for k, v in kw.items()})
    return t, j


RGB_CASES = {
    "auto_linked": {},
    "auto_unlinked_scnr": dict(linked=False, scnr=True),
    "manual_wb": dict(wb="manual"),
    "no_wb_no_align": dict(wb="none", align=False),
    "fixed_stf": dict(auto_stretch=False, wb="none"),
    "missing_g": dict(drop="g"),
    "missing_r": dict(drop="r", linked=False),
    "mismatched_b": dict(half="b"),
    "affine": dict(method="affine", scnr=True),
}


@pytest.mark.parametrize("case", sorted(RGB_CASES))
def test_process_rgb_matches_oracle_and_jax(case):
    spec = RGB_CASES[case]
    if spec.get("method") == "affine":
        chans = affine_rgb()
    else:
        chans = star_rgb()
    if spec.get("half"):
        k = "rgb".index(spec["half"])
        chans[k] = np.ascontiguousarray(chans[k][::2, ::2])
    if spec.get("drop"):
        chans["rgb".index(spec["drop"])] = None
    tcfg, jcfg = _configs(spec)
    got = trgb.process_rgb(*(None if c is None else _t(c) for c in chans),
                           tcfg)
    want = jrgb.process_rgb(*chans, jcfg)

    # the port against its own pipeline in numpy
    r, g, b, rows, cols, info = trgb.harmonize_dimensions(
        *(None if c is None else _t(c) for c in chans))
    assert (got.rows, got.cols) == (rows, cols) == (want.rows, want.cols)
    assert (info is None) == (want.dimension_info is None)
    if info is not None:
        assert info.to_dict() == want.dimension_info.to_dict()
    if tcfg.align:
        aligned = trgb.align_rgb_channels(r, g, b, rows, cols,
                                          tcfg.align_method)[:3]
    else:
        aligned = (trgb.channel_or_synth(r, g, b, rows, cols),
                   trgb.channel_or_synth(g, r, b, rows, cols),
                   trgb.channel_or_synth(b, r, g, rows, cols))
    aligned = [a.numpy() for a in aligned]
    for a, s in zip(aligned, (got.stats_r, got.stats_g, got.stats_b)):
        assert trgb.compute_image_stats(_t(a)) == s
    pre, params, out = _oracle_rgb(got, tcfg, aligned)
    for n, p, q, o in zip("rgb", pre, params, out):
        np.testing.assert_array_equal(getattr(got, f"pre_stretch_{n}")
                                      .numpy(), p)
        assert getattr(got, f"stf_{n}") == q
        np.testing.assert_array_equal(getattr(got, n).numpy(), o)
    assert got.scnr_applied == (tcfg.scnr is not None) == want.scnr_applied

    # against JAX: the planes move by the offsets' difference times
    # their gradient, and the white balance by its factors' difference
    if tcfg.align:
        tol_off = 1e-3 if spec.get("method") == "affine" else 0.05
        np.testing.assert_allclose(got.offset_g, want.offset_g, atol=tol_off)
        np.testing.assert_allclose(got.offset_b, want.offset_b, atol=tol_off)
    else:
        assert got.offset_g == got.offset_b == (0.0, 0.0)
    d_off = max(float(np.abs(np.subtract(got.offset_g, want.offset_g))
                      .sum()), float(np.abs(np.subtract(
                          got.offset_b, want.offset_b)).sum()))
    wb_t = _factors(tcfg, (got.stats_r, got.stats_g, got.stats_b))
    wb_j = _factors(tcfg, (want.stats_r, want.stats_g, want.stats_b))
    wb_rel = max(abs(a / b - 1.0) for a, b in zip(wb_t, wb_j))
    tol_pre = 1e-4 if spec.get("method") == "affine" else 1e-6
    for n, a in zip("rgb", aligned):
        move = d_off * _grad_max(a)
        _stats_close(getattr(got, f"stats_{n}"), getattr(want, f"stats_{n}"),
                     n, tol_pre, move)
        _stats_close(getattr(got, f"stats_wb_{n}"),
                     getattr(want, f"stats_wb_{n}"), n, wb_rel + tol_pre,
                     2 * move)
        _stf_close(getattr(got, f"stf_{n}"), getattr(want, f"stf_{n}"))
        p = getattr(got, f"pre_stretch_{n}").numpy()
        jp = np.asarray(getattr(want, f"pre_stretch_{n}"))
        fin = np.isfinite(jp)
        top = float(np.abs(jp[fin]).max())
        assert (np.abs(p - jp)[fin] <= (wb_rel * np.abs(jp) + tol_pre * top
                                        + 2 * move)[fin]).all(), n
        _stretched_close(getattr(got, n).numpy(), np.asarray(getattr(
            want, n)), p, jp, getattr(got, f"stf_{n}"),
            getattr(got, f"stats_wb_{n}"), getattr(want, f"stf_{n}"),
            getattr(want, f"stats_wb_{n}"), tcfg.scnr is not None)


def test_process_rgb_needs_two_channels():
    r, _, _ = star_rgb(32, 32)
    with pytest.raises(InvalidInput, match="at least 2"):
        trgb.process_rgb(_t(r), None, None)
    with pytest.raises(JInvalidInput, match="at least 2"):
        jrgb.process_rgb(r, None, None)


def test_rgb_compose_config_defaults_match_jax():
    import dataclasses
    got = dataclasses.asdict(td.RgbComposeConfig())
    want = dataclasses.asdict(jd.RgbComposeConfig())

    def plain(d):
        return {k: (plain(v) if isinstance(v, dict) else
                    getattr(v, "value", v)) for k, v in d.items()}

    assert plain(got) == plain(want)
    assert got["linked_stf"] is True


# ---- drizzle_rgb --------------------------------------------------------------


@pytest.mark.parametrize("case", ["auto_linked", "manual_unlinked_scnr",
                                  "none_identity", "missing_b"])
def test_process_drizzle_rgb_matches_oracle_and_jax(case):
    r, g, b = star_rgb(96, 112, shifts=((0, 0), (0, 0)))
    g = np.ascontiguousarray(np.pad(g, ((0, 4), (0, 2)), mode="edge"))
    wb = {"auto_linked": td.WhiteBalance(),
          "manual_unlinked_scnr": td.WhiteBalance(
              td.WhiteBalanceMode.MANUAL, 1.2, 0.9, 1.05),
          "none_identity": td.WhiteBalance(td.WhiteBalanceMode.NONE),
          "missing_b": td.WhiteBalance()}[case]
    tcfg = tdrz.DrizzleRgbConfig(
        white_balance=wb, linked_stf=case != "manual_unlinked_scnr",
        auto_stretch=case != "none_identity",
        scnr=td.ScnrConfig() if "scnr" in case else None)
    jcfg = jdrz.DrizzleRgbConfig(
        white_balance=jd.WhiteBalance(jd.WhiteBalanceMode(wb.mode.value),
                                      wb.r, wb.g, wb.b),
        linked_stf=tcfg.linked_stf, auto_stretch=tcfg.auto_stretch,
        scnr=jd.ScnrConfig() if "scnr" in case else None)
    if case == "missing_b":
        b = None
    got = tdrz.process_drizzle_rgb(_t(r), _t(g), None if b is None else _t(b),
                                   tcfg)
    want = jdrz.process_drizzle_rgb(r, g, b, jcfg)
    assert got.out_dims == want.out_dims == (96, 112)
    # the port's own pipeline in numpy: crop, WB, the merge by / 3.0
    planes = [p[:96, :112] if p is not None else np.zeros((96, 112), F)
              for p in (r, g, b)]
    wbf = got.wb
    if wb.mode == td.WhiteBalanceMode.AUTO:
        assert wbf == twb.select_wb_reference(*(
            trgb.compute_image_stats(_t(p)) for p in planes))
    lin = [p * F(m) for p, m in zip(planes, wbf)]
    for n, p in zip("rgb", lin):
        np.testing.assert_array_equal(getattr(got, f"{n}_linear").numpy(), p)
    if tcfg.auto_stretch and tcfg.linked_stf:
        merged = (lin[0] + lin[1] + lin[2]) / F(3.0)
        assert got.stf_r == trgb.auto_stf(trgb.compute_image_stats(
            _t(merged)))
    outs = [np_stf(p, getattr(got, f"stf_{n}"), getattr(got, f"stats_{n}"))
            for n, p in zip("rgb", lin)]
    if tcfg.scnr is not None:
        outs = ref_apply_scnr(*outs, "average_neutral", 1.0, False)
    for n, o in zip("rgb", outs):
        np.testing.assert_array_equal(getattr(got, f"{n}_stretched").numpy(),
                                      o)
    # against JAX: the white-balance factors are ratios of medians (C5)
    wb_rel = max(abs(a / b - 1.0) for a, b in zip(wbf, want.wb))
    assert wb_rel <= 1e-4
    for n in "rgb":
        _stats_close(getattr(got, f"stats_{n}"), getattr(want, f"stats_{n}"),
                     n, wb_rel + 1e-6)
        _stf_close(getattr(got, f"stf_{n}"), getattr(want, f"stf_{n}"))
        gl = getattr(got, f"{n}_linear").numpy()
        jl = np.asarray(getattr(want, f"{n}_linear"))
        assert (np.abs(gl - jl) <= (wb_rel + 1e-6) * np.abs(jl)).all()
        _stretched_close(getattr(got, f"{n}_stretched").numpy(),
                         np.asarray(getattr(want, f"{n}_stretched")), gl, jl,
                         getattr(got, f"stf_{n}"), getattr(got, f"stats_{n}"),
                         getattr(want, f"stf_{n}"),
                         getattr(want, f"stats_{n}"), tcfg.scnr is not None)


def test_drizzle_rgb_matches_jax():
    rng = np.random.default_rng(8)
    base = star_rgb(48, 48, shifts=((0, 0), (0, 0)))
    frames = {}
    for k, n in enumerate("rgb"):
        frames[n] = [np.roll(base[k], tuple(s), (0, 1)) +
                     rng.normal(0, 0.002, (48, 48)).astype(np.float32)
                     for s in ((0, 0), (1, -2), (-2, 1))]
    got, gres = tdrz.drizzle_rgb(*([_t(f) for f in frames[n]] for n in "rgb"))
    want, wres = jdrz.drizzle_rgb(*(frames[n] for n in "rgb"))
    assert got.frame_counts == want.frame_counts == {"r": 3, "g": 3, "b": 3}
    assert got.out_dims == want.out_dims == (96, 96)
    for n in "rgb":
        np.testing.assert_allclose(gres[n].offsets, wres[n].offsets,
                                   atol=0.05)
        _stf_close(getattr(got, f"stf_{n}"), getattr(want, f"stf_{n}"))
        assert torch.isfinite(getattr(got, f"{n}_stretched")).all()
        # the assembly is process_drizzle_rgb on the drizzled planes
        again = tdrz.process_drizzle_rgb(gres["r"].image, gres["g"].image,
                                         gres["b"].image)
        assert torch.equal(getattr(again, f"{n}_stretched"),
                           getattr(got, f"{n}_stretched"))
