"""PyTorch port: the 11 compose commands (``api/compose.py``) end to end
against the JAX package's (astroburst_tpu/api/compose.py), on FITS
files written here from the seeded planes of tests/test_torch_compose.py
(160² star fields with sub-pixel shifts of G and B; a 256² field with B
shifted and G rotated by 0.4°).

Tolerances, and why:

- responses: the same key set and every value but ``elapsed_ms`` and
  the paths equal, except those that follow the medians or the
  offsets: offsets within 0.05 px of JAX's (phase correlation, under
  ``jax_parabola_vertex``, ROADMAP C8) or 1e-3 (affine); STF parameters
  within 1e-4 and stats within the compare-count error range/8⁶ of
  JAX's medians (C5), moved by the white-balance factors' and the
  offsets' differences (the bounds of tests/test_torch_compose.py);
  white-balance factors within 1e-4 relative (ratios of medians);
- cache planes and written files: bit-equal to the port's own module
  calls on the same inputs (``process_rgb``, ``blend_channels``,
  ``align_pair``, the crop), and to JAX's within the module bounds of
  tests/test_torch_compose.py;
- PNGs as decoded pixels, never bytes (C16): equal to the port's own
  quantisation of its planes; against JAX's, within the level change
  of the stretched planes' bound (C5 through the MTF), checked as: no
  pixel more than 8 levels apart and at most 1% more than one level;
- the composite's ORIG planes are never written through KEY: after
  calibrate → reset → calibrate → restretch → tone → arcsinh, ORIG is
  bit-equal to the blend's output.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from astroburst_tpu import api as japi
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE as JCACHE
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch import dtypes as td
from astroburst_tpu_torch.alignment.pair import align_pair
from astroburst_tpu_torch.api import helpers as thelpers
from astroburst_tpu_torch.api.compose import detect_valid_region
from astroburst_tpu_torch.compose import channel_blend as tblend
from astroburst_tpu_torch.compose import lrgb as tlrgb
from astroburst_tpu_torch.compose import rgb as trgb
from astroburst_tpu_torch.errors import CacheMiss, InvalidInput
from astroburst_tpu_torch.imaging.resample import resample_image
from astroburst_tpu_torch.imaging.scnr import apply_scnr
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, apply_stf_u8, \
    auto_stf
from astroburst_tpu_torch.io import extract_image, write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.metadata.presets import resolve_preset_weights
from astroburst_tpu_torch.ops.ipc import nearest_downsample
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from tests.test_torch_api_export import _png_pixels
from tests.test_torch_compose import (RES, _stf_close, _t, affine_rgb,
                                      star_rgb)
from tests.test_torch_phase_correlation import (  # noqa: F401
    jax_parabola_vertex)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CARDS = [("OBJECT", "'M 16'"), ("CRPIX1", "80.5"), ("CRPIX2", "70.25"),
         ("CRVAL1", "274.7"), ("CRVAL2", "-13.8")]


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _fits(tmp_path, name, img, cards=CARDS):
    p = str(tmp_path / f"{name}.fits")
    write_fits_mono(p, img, HduHeader(list(cards)))
    return p


def _dirs(tmp_path):
    return str(tmp_path / "t"), str(tmp_path / "j")


def _u8(planes):
    """The port's RGB preview pixels of stretched planes."""
    return np.stack([thelpers._to_u8(nearest_downsample(p, 4096)).numpy()
                     for p in planes], -1).astype(np.int64)


def _stf_u8(planes, params, stats):
    return np.stack([apply_stf_u8(nearest_downsample(p, 4096), q, s).numpy()
                     for p, q, s in zip(planes, params, stats)],
                    -1).astype(np.int64)


def _png_near(got_path, want_path):
    """Decoded PNG pixels within the stretched planes' bound of JAX's."""
    a, b = _png_pixels(got_path), _png_pixels(want_path)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 8 and (d > 1).mean() <= 0.01, (d.max(), (d > 1).mean())


def _stats_brief_close(got, want, extra=0.0):
    """Stats of planes that differ by up to ``extra``: the median within
    the compare-count error (C5) too, and everything within the
    white-balance factors' difference (rel 2e-4)."""
    rng = max(want[C.RES_MAX] - want[C.RES_MIN], 1e-30)
    for k in (C.RES_MEDIAN, C.RES_MEAN, C.RES_MIN, C.RES_MAX):
        assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k]) + extra + \
            4 * rng / RES, k


def _same(a, b):
    """Bit-equal f32 tensors (NaN payloads included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _grad_max(plane):
    d = [torch.abs(torch.diff(plane, dim=k)) for k in (0, 1)]
    return max(float(x[torch.isfinite(x)].max()) for x in d)


def _keys_same(got, want, skip=()):
    assert set(got) == set(want)
    for k in got:
        if k.endswith("_path") or k == C.RES_ELAPSED_MS or k in skip:
            continue
        assert got[k] == want[k], k


def _cache_planes(cache, keys, dev=None):
    out = []
    for k in keys:
        e = cache.get(k) if dev is None else cache.get(k, dev)
        out.append(None if e is None else e)
    return out


# ---- compose_rgb_cmd ----------------------------------------------------------


COMPOSE_CASES = {
    "phase_correlation": {},
    "affine_scnr": dict(align_method="affine", scnr_enabled=True,
                        scnr_method="maximum", scnr_amount=0.8),
    "missing_g": dict(drop="g", linked_stf=True),
    "mismatched_b": dict(half="b"),
    "manual_wb_linked": dict(wb_mode="manual", wb_r=1.1, wb_g=0.0,
                             wb_b=1.3, linked_stf=True),
    "no_wb_no_align": dict(wb_mode="none", align=False),
    "lrgb": dict(lrgb=True, lrgb_lightness=0.8, lrgb_chrominance=0.9),
    "lrgb_resampled_no_stretch": dict(lrgb=True, half="l",
                                      auto_stretch=False),
}


def _compose_files(tmp_path, spec):
    chans = affine_rgb() if spec.get("align_method") == "affine" \
        else star_rgb()
    lum = np.clip(0.2126 * chans[0] + 0.7152 * chans[1] + 0.0722 * chans[2]
                  + 0.01, 0, None).astype(np.float32) if spec.get("lrgb") \
        else None
    planes = dict(zip("rgb", chans), l=lum)
    if spec.get("half"):
        planes[spec["half"]] = np.ascontiguousarray(
            planes[spec["half"]][::2, ::2])
    if spec.get("drop"):
        planes[spec["drop"]] = None
    return {f"{c}_path": (_fits(tmp_path, c, p) if p is not None else None)
            for c, p in planes.items()}


@pytest.mark.parametrize("case", sorted(COMPOSE_CASES))
def test_compose_rgb_cmd_matches_module_and_jax(tmp_path, case):
    spec = COMPOSE_CASES[case]
    kw = {k: v for k, v in spec.items()
          if k not in ("drop", "half", "lrgb")}
    paths = _compose_files(tmp_path, spec)
    a, b = _dirs(tmp_path)
    got = tapi.compose_rgb_cmd(a, **paths, **kw, device=CPU)
    want = japi.compose_rgb_cmd(b, **paths, **kw)
    _keys_same(got, want, skip=(C.RES_OFFSET_G, C.RES_OFFSET_B, C.STF_R,
                                C.STF_G, C.STF_B, C.RES_STATS_R,
                                C.RES_STATS_G, C.RES_STATS_B))
    assert got[C.LRGB_APPLIED] == bool(spec.get("lrgb"))
    assert got[C.RESAMPLED] == (spec.get("half") in ("r", "g", "b"))
    tol = 1e-3 if spec.get("align_method") == "affine" else 0.05
    for k in (C.RES_OFFSET_G, C.RES_OFFSET_B):
        np.testing.assert_allclose(got[k], want[k], atol=tol)
    for k in (C.STF_R, C.STF_G, C.STF_B):
        _stf_close(td.StfParams(**got[k]), td.StfParams(**want[k]))

    # the command is the module calls
    img = {c: (torch.from_numpy(extract_image(p).image)
               if p else None) for c, p in
           (("r", paths["r_path"]), ("g", paths["g_path"]),
            ("b", paths["b_path"]), ("l", paths["l_path"]))}
    cfg = td.RgbComposeConfig(
        white_balance=thelpers.parse_wb(kw.get("wb_mode"), kw.get("wb_r"),
                                        kw.get("wb_g"), kw.get("wb_b")),
        auto_stretch=kw.get("auto_stretch", True),
        linked_stf=kw.get("linked_stf", False), align=kw.get("align", True),
        align_method=thelpers.parse_align_method(kw.get("align_method")),
        scnr=thelpers.parse_scnr_config(kw.get("scnr_enabled"),
                                        kw.get("scnr_method"),
                                        kw.get("scnr_amount"), None))
    mod = trgb.process_rgb(img["r"], img["g"], img["b"], cfg)
    assert got[C.RES_OFFSET_G] == list(mod.offset_g)
    assert got[C.RES_STATS_R] == thelpers.stats_brief(mod.stats_r)
    assert got[C.STF_B] == mod.stf_b.to_dict()
    d_off = max(float(np.abs(np.subtract(got[k], want[k])).sum())
                for k in (C.RES_OFFSET_G, C.RES_OFFSET_B))
    for k, n in zip((C.RES_STATS_R, C.RES_STATS_G, C.RES_STATS_B), "rgb"):
        pre = getattr(mod, f"pre_stretch_{n}")
        top = float(pre[torch.isfinite(pre)].abs().max())
        _stats_brief_close(got[k], want[k], (
            1e-4 if kw.get("align_method") else 1e-6) * top
            + d_off * _grad_max(pre))
    keys = (C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B,
            C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B)
    ent = _cache_planes(GLOBAL_IMAGE_CACHE, keys, CPU)
    for k, n in enumerate("rgb"):
        assert ent[k].image is ent[k + 3].image        # ORIG and KEY one
        assert _same(ent[k].image, getattr(mod, f"pre_stretch_{n}"))
        assert ent[k].stats == getattr(mod, f"stats_wb_{n}")
        jp = np.asarray(JCACHE.get(keys[k]).image)
        assert jp.shape == tuple(ent[k].image.shape)
    planes = [mod.r, mod.g, mod.b]
    if img["l"] is not None:
        l_data = resample_image(img["l"], mod.rows, mod.cols)
        if cfg.auto_stretch:
            st = compute_image_stats(l_data)
            l_data = apply_stf_f32(l_data, auto_stf(st), st)
        planes = tlrgb.apply_lrgb(l_data, *planes,
                                  kw.get("lrgb_lightness", 1.0),
                                  kw.get("lrgb_chrominance", 1.0))
    px = _png_pixels(got[C.RES_PNG_PATH])
    np.testing.assert_array_equal(px, _u8(planes))
    _png_near(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH])
    assert os.path.basename(got[C.RES_PNG_PATH]).startswith("rgb_composite_")


def test_compose_rgb_cmd_ratio_cap_and_too_few_channels(tmp_path):
    big = star_rgb(96, 96)[0]
    small = np.ascontiguousarray(big[::9, ::9])
    pr, pg = _fits(tmp_path, "big", big), _fits(tmp_path, "small", small)
    for api, dev in ((tapi, {"device": CPU}), (japi, {})):
        with pytest.raises(Exception, match="exceeds"):
            api.compose_rgb_cmd(str(tmp_path / "o"), r_path=pr, g_path=pg,
                                **dev)
        with pytest.raises(Exception, match="at least 2"):
            api.compose_rgb_cmd(str(tmp_path / "o"), r_path=pr, **dev)


# ---- restretch, update, clear ---------------------------------------------------


@pytest.mark.parametrize("scnr", [False, True])
def test_restretch_update_and_clear_match_jax(tmp_path, scnr):
    paths = _compose_files(tmp_path, {})
    a, b = _dirs(tmp_path)
    tapi.compose_rgb_cmd(a, **paths, device=CPU)
    japi.compose_rgb_cmd(b, **paths)
    args = (0.05, 0.2, 1.0, 0.04, 0.3, 0.95, 0.06, 0.25, 1.0)
    skw = dict(scnr_enabled=True, scnr_method="average",
               scnr_amount=0.6) if scnr else {}
    got = tapi.restretch_composite_cmd(a, *args, **skw, device=CPU)
    want = japi.restretch_composite_cmd(b, *args, **skw)
    _keys_same(got, want)
    er, eg, eb = thelpers.load_composite_rgb(CPU)
    planes = [apply_stf_f32(e.image, td.StfParams(*args[3 * i:3 * i + 3]),
                            e.stats) for i, e in enumerate((er, eg, eb))]
    if scnr:
        planes = list(apply_scnr(*planes, thelpers.parse_scnr_config(
            True, "average", 0.6, None)))
    np.testing.assert_array_equal(_png_pixels(got[C.RES_PNG_PATH]),
                                  _u8(planes))
    _png_near(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH])

    # swap G for another file: ORIG and KEY one tensor, the file's plane
    other = _fits(tmp_path, "other", star_rgb(seed=4)[1])
    got = tapi.update_composite_channel_cmd("G", other, device=CPU)
    want = japi.update_composite_channel_cmd("G", other)
    _keys_same(got, want)
    assert got == {C.RES_CHANNEL: "g", C.RES_PATH: other,
                   C.RES_ELAPSED_MS: got[C.RES_ELAPSED_MS]}
    og = GLOBAL_IMAGE_CACHE.get(C.COMPOSITE_ORIG_G, CPU)
    kg = GLOBAL_IMAGE_CACHE.get(C.COMPOSITE_KEY_G, CPU)
    assert og.image is kg.image and og.stats == kg.stats
    np.testing.assert_array_equal(og.image.numpy(),
                                  extract_image(other).image)
    assert og.stats == compute_image_stats(og.image)
    np.testing.assert_array_equal(og.image.numpy(),
                                  np.asarray(JCACHE.get(C.COMPOSITE_KEY_G)
                                             .image))
    for api, kw in ((tapi, {"device": CPU}), (japi, {})):
        with pytest.raises(Exception, match="Unknown channel"):
            api.update_composite_channel_cmd("x", other, **kw)

    assert tapi.clear_composite_cache_cmd(device=CPU) is None
    japi.clear_composite_cache_cmd()
    for key in (C.COMPOSITE_KEY_R, C.COMPOSITE_ORIG_B):
        assert GLOBAL_IMAGE_CACHE.get(key) is None and JCACHE.get(key) is None
    for api, kw in ((tapi, {"device": CPU}), (japi, {})):
        with pytest.raises(Exception, match="recompose"):
            api.restretch_composite_cmd(a, *args, **kw)


# ---- the wizard: blend → auto WB → WB + SCNR → reset ------------------------------


def _narrowband(tmp_path):
    base = star_rgb(128, 128, shifts=((0, 0), (0, 0)))
    rng = np.random.default_rng(12)
    planes = {"sii": base[0] * 0.7, "ha": base[0],
              "oiii": np.ascontiguousarray(base[2][::2, ::2]) * 0.5,
              "l": base[1] + rng.normal(0, 0.002, base[1].shape)}
    planes["ha"][5, 7] = np.nan
    return {k: _fits(tmp_path, k, v.astype(np.float32))
            for k, v in planes.items()}


@pytest.mark.parametrize("preserve", [False, True])
def test_wizard_color_flow_matches_module_and_jax(tmp_path, preserve):
    files = _narrowband(tmp_path)
    bins = ["sii", "ha", "oiii", "l"]
    paths = [files[b] for b in bins]
    weights = [{"channelIdx": w["channel_idx"], "r": w["r_weight"],
                "g": w["g_weight"], "b": w["b_weight"]}
               for w in resolve_preset_weights("hubble_legacy", bins)]
    weights.append({"channel_idx": 9, "r_weight": 1.0})   # out of range
    weights.append({"r": 1.0})                            # no index
    a, b = _dirs(tmp_path)
    got = tapi.blend_channels_cmd(paths, weights, a, "hubble_legacy",
                                  device=CPU)
    want = japi.blend_channels_cmd(paths, weights, b, "hubble_legacy")
    _keys_same(got, want, skip=(C.RES_STATS_R, C.RES_STATS_G, C.RES_STATS_B,
                                C.RES_AUTO_STF))
    assert got[C.RES_DIMENSIONS] == [128, 128]
    assert got[C.RES_CHANNEL_COUNT] == 4
    assert got[C.RES_BLEND_PRESET] == "hubble_legacy"
    _stf_close(td.StfParams(**got[C.RES_AUTO_STF]),
               td.StfParams(**want[C.RES_AUTO_STF]))
    for k in (C.RES_STATS_R, C.RES_STATS_G, C.RES_STATS_B):
        _stats_brief_close(got[k], want[k])
    ins = [resample_image(torch.from_numpy(extract_image(p).image), 128, 128)
           for p in paths]
    blended = tblend.blend_channels(ins, [
        {"channel_idx": w.get("channelIdx", w.get("channel_idx")),
         "r_weight": w.get("r", w.get("r_weight", 0.0)),
         "g_weight": w.get("g", w.get("g_weight", 0.0)),
         "b_weight": w.get("b", w.get("b_weight", 0.0))}
        for w in weights if "channelIdx" in w or "channel_idx" in w])
    orig = thelpers.load_composite_orig_rgb(CPU)
    key = thelpers.load_composite_rgb(CPU)
    for o, k_, p in zip(orig, key, blended):
        assert _same(o.image, p) and o.image is k_.image
    jorig = [np.asarray(JCACHE.get(k).image) for k in (
        C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B)]
    for o, j in zip(orig, jorig):   # the blend: 4 ulp of the sum (C13)
        fin = np.isfinite(j)
        np.testing.assert_allclose(o.image.numpy()[fin], j[fin], rtol=0,
                                   atol=4 * 2 ** -23 * float(
                                       np.abs(j[fin]).max()))
    stats = [o.stats for o in orig]
    linked = thelpers.compute_linked_stf(*stats)
    np.testing.assert_array_equal(_png_pixels(got[C.RES_PNG_PATH]),
                                  _stf_u8(blended, [linked] * 3, stats))
    _png_near(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH])
    snap = [o.image.clone() for o in orig]

    wb = tapi.compute_auto_wb_cmd(device=CPU)
    jwb = japi.compute_auto_wb_cmd()
    assert set(wb) == set(jwb) == {C.RES_R_FACTOR, C.RES_G_FACTOR,
                                   C.RES_B_FACTOR}
    for k in wb:
        assert wb[k] == pytest.approx(jwb[k], rel=1e-4)
    factors = (wb[C.RES_R_FACTOR], wb[C.RES_G_FACTOR], wb[C.RES_B_FACTOR])
    skw = dict(scnr_enabled=True, scnr_method="maximum", scnr_amount=0.7,
               scnr_preserve_luminance=preserve)
    got = tapi.calibrate_and_scnr_cmd(a, *factors, **skw, device=CPU)
    want = japi.calibrate_and_scnr_cmd(b, *factors, **skw)
    _keys_same(got, want, skip=(C.RES_AUTO_STF,))
    assert got[C.RES_SCNR_APPLIED] and got[C.RES_WB_APPLIED]
    _stf_close(td.StfParams(**got[C.RES_AUTO_STF]),
               td.StfParams(**want[C.RES_AUTO_STF]))
    r, g, b_ = (o.image * f for o, f in zip(orig, factors))
    cfg = thelpers.parse_scnr_config(True, "maximum", 0.7, preserve)
    r2, g2, b2 = apply_scnr(r, g, b_, cfg)
    key = thelpers.load_composite_rgb(CPU)
    for k_, p in zip(key, (r2, g2, b2)):
        assert _same(k_.image, p)
    assert key[1].stats == compute_image_stats(g2)
    # R's and B's stats are taken again only when SCNR preserves the
    # luminance (it changes them only then)
    assert key[0].stats == compute_image_stats(r2 if preserve else r)
    assert key[2].stats == compute_image_stats(b2 if preserve else b_)
    if not preserve:
        assert _same(r2, r)
    for k_, o in zip(key, orig):
        assert k_.image.data_ptr() != o.image.data_ptr()
    jkey = [np.asarray(JCACHE.get(k).image) for k in (
        C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B)]
    for k_, j in zip(key, jkey):    # the blend's ulps, then SCNR's (C25)
        fin = np.isfinite(j)
        np.testing.assert_allclose(k_.image.numpy()[fin], j[fin], rtol=0,
                                   atol=16 * 2 ** -23 * float(
                                       np.abs(j[fin]).max()))
    linked = thelpers.compute_linked_stf(*(k_.stats for k_ in key))
    np.testing.assert_array_equal(
        _png_pixels(got[C.RES_PNG_PATH]),
        _stf_u8([k_.image for k_ in key], [linked] * 3,
                [k_.stats for k_ in key]))
    _png_near(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH])

    got = tapi.reset_wb_cmd(a, device=CPU)
    want = japi.reset_wb_cmd(b)
    _keys_same(got, want, skip=(C.RES_AUTO_STF,))
    assert got["reset"] is True
    key = thelpers.load_composite_rgb(CPU)
    for k_, o in zip(key, orig):
        assert k_.image is o.image and k_.stats == o.stats
    linked = thelpers.compute_linked_stf(*stats)
    assert got[C.RES_AUTO_STF] == linked.to_dict()
    _png_near(got[C.RES_PNG_PATH], want[C.RES_PNG_PATH])

    # later commands never write into ORIG through KEY
    tapi.calibrate_and_scnr_cmd(a, 1.3, 0.8, 1.1, True, None, 1.0, True,
                                device=CPU)
    tapi.restretch_composite_cmd(a, 0.0, 0.5, 1.0, 0.0, 0.5, 1.0, 0.0, 0.5,
                                 1.0, True, device=CPU)
    tapi.reset_wb_cmd(a, device=CPU)
    tapi.apply_tone_composite_cmd(a, linked_stf=True, scnr={
        "method": "average", "amount": 1.0}, device=CPU)
    tapi.arcsinh_stretch_composite_cmd(a, 20.0, device=CPU)
    tapi.masked_stretch_composite_cmd(a, iterations=2, device=CPU)
    for o, s in zip(thelpers.load_composite_orig_rgb(CPU), snap):
        assert _same(o.image, s)


def test_calibrate_floors_factors_and_needs_orig(tmp_path):
    files = _narrowband(tmp_path)
    a, b = _dirs(tmp_path)
    for api, kw in ((tapi, {"device": CPU}), (japi, {})):
        with pytest.raises(Exception, match="Run Blend first"):
            api.calibrate_and_scnr_cmd(a, 1.0, 1.0, 1.0, **kw)
        with pytest.raises(Exception, match="Run Blend first"):
            api.reset_wb_cmd(a, **kw)
    w = [{"channel_idx": 1, "r_weight": 1.0, "g_weight": 0.5,
          "b_weight": 0.2}]
    tapi.blend_channels_cmd([files["ha"], files["l"]], w, a, device=CPU)
    japi.blend_channels_cmd([files["ha"], files["l"]], w, b)
    got = tapi.calibrate_and_scnr_cmd(a, -2.0, 0.0, 1e-9, device=CPU)
    want = japi.calibrate_and_scnr_cmd(b, -2.0, 0.0, 1e-9)
    _keys_same(got, want, skip=(C.RES_AUTO_STF,))
    assert not got[C.RES_SCNR_APPLIED]
    assert (got[C.RES_R_FACTOR], got[C.RES_G_FACTOR]) == (-2.0, 0.0)
    orig = thelpers.load_composite_orig_rgb(CPU)
    for k_, o in zip(thelpers.load_composite_rgb(CPU), orig):
        assert _same(k_.image, o.image * 1e-6)
    # a channel with no weight is all zero: SCNR at amount 0 is off
    got = tapi.calibrate_and_scnr_cmd(a, 1.0, 1.0, 1.0, True, None, 0.0,
                                      device=CPU)
    assert not got[C.RES_SCNR_APPLIED]


# ---- the wizard: align → crop → export -------------------------------------------


def _bordered(tmp_path, affine):
    chans = affine_rgb() if affine else star_rgb()
    borders = ((3, 0, 5, 2), (0, 4, 2, 6), (6, 2, 0, 3))
    out = []
    for k, (c, (t, bo, le, ri)) in enumerate(zip(chans, borders)):
        c = c.copy()
        h, w = c.shape
        c[:t], c[h - bo:], c[:, :le], c[:, w - ri:] = 0.0, 0.0, 0.0, 0.0
        if k == 1:
            c[40, 40] = np.nan
        cards = [x for x in CARDS if x[0] not in ("CRPIX1", "CRPIX2")] + [
            ("CRPIX1", f"{80.5 + k}"), ("CRPIX2", f"{70.25 - k}")]
        out.append(_fits(tmp_path, f"ch_{k}", c, cards))
    return out


@pytest.mark.parametrize("method", [None, "affine"])
def test_align_crop_export_flow_matches_module_and_jax(tmp_path, method):
    paths = _bordered(tmp_path, method == "affine")
    a, b = _dirs(tmp_path)
    bins = ["ha", "oiii"]          # the third channel gets "ch2"
    got = tapi.align_channels_cmd(paths, a, method, bins, True, device=CPU)
    want = japi.align_channels_cmd(paths, b, method, bins, True)
    _keys_same(got, want, skip=(C.CHANNELS,))
    assert got[C.RES_CACHE_KEYS] == [C.wizard_aligned_key(x) for x in
                                     ("ha", "oiii", "ch2")]
    assert got[C.ALIGN_METHOD] == (method or "phase_correlation")
    tol = 1e-3 if method else 0.05
    imgs = [torch.from_numpy(extract_image(p).image) for p in paths]
    am = thelpers.parse_align_method(method)
    for i, (g, w) in enumerate(zip(got[C.CHANNELS], want[C.CHANNELS])):
        assert set(g) == set(w)
        assert (g[C.RES_CHANNEL], g["method"], g["cache_key"]) == \
            (w[C.RES_CHANNEL], w["method"], w["cache_key"])
        np.testing.assert_allclose(g[C.RES_OFFSET], w[C.RES_OFFSET],
                                   atol=tol)
        assert g[C.RES_CONFIDENCE] == pytest.approx(w[C.RES_CONFIDENCE],
                                                    rel=1e-3)
        entry = GLOBAL_IMAGE_CACHE.get(g["cache_key"], CPU)
        if i == 0:
            assert _same(entry.image, imgs[0])
            continue
        assert (g["inliers"], ) == (w["inliers"], )
        res = align_pair(imgs[0], imgs[i], am, *imgs[0].shape)
        assert g[C.RES_OFFSET] == [float(v) for v in res.offset]
        assert _same(entry.image, res.aligned)
        assert entry.stats == compute_image_stats(res.aligned)
        assert entry.header.get("OBJECT") == "M 16"
        disk = os.path.join(a, f"aligned_{g[C.RES_CHANNEL]}.fits")
        np.testing.assert_array_equal(extract_image(disk).image,
                                      res.aligned.numpy())
    assert os.path.exists(os.path.join(b, "aligned_oiii.fits"))

    keys = got[C.RES_CACHE_KEYS]
    got = tapi.crop_channels_cmd(keys, a, bins, device=CPU)
    want = japi.crop_channels_cmd(keys, b, bins)
    _keys_same(got, want)
    reg = got["crop_region"]
    regions = [detect_valid_region(GLOBAL_IMAGE_CACHE.get(k, CPU).image,
                                   1e-6) for k in keys]
    assert (reg["top"], reg["bottom"], reg["left"], reg["right"]) == (
        max(r[0] for r in regions), min(r[1] for r in regions),
        max(r[2] for r in regions), min(r[3] for r in regions))
    assert reg["top"] > 0 and reg["left"] > 0
    assert got[C.RES_CACHE_KEYS] == [C.wizard_cropped_key(x) for x in
                                     ("ha", "oiii", "ch2")]
    for k, ck in zip(keys, got[C.RES_CACHE_KEYS]):
        src = GLOBAL_IMAGE_CACHE.get(k, CPU).image
        e = GLOBAL_IMAGE_CACHE.get(ck, CPU)
        assert e.image.is_contiguous()
        assert e.image.data_ptr() != src.data_ptr()
        assert _same(e.image, src[reg["top"]:reg["bottom"],
                                  reg["left"]:reg["right"]])
        assert e.stats == compute_image_stats(e.image)

    got = tapi.export_aligned_channels_cmd(paths, a, method, device=CPU)
    want = japi.export_aligned_channels_cmd(paths, b, method)
    _keys_same(got, want, skip=(C.CHANNELS,))
    for i, (g, w) in enumerate(zip(got[C.CHANNELS], want[C.CHANNELS])):
        assert set(g) == set(w)
        assert os.path.basename(g[C.RES_PATH]) == f"ch_{i}_aligned.fits"
        np.testing.assert_allclose(g[C.RES_OFFSET], w[C.RES_OFFSET],
                                   atol=tol)
        fi = extract_image(g[C.RES_PATH])
        jfi = extract_image(w[C.RES_PATH])
        if i == 0:
            np.testing.assert_array_equal(fi.image, imgs[0].numpy())
        else:
            res = align_pair(imgs[0], imgs[i], am, *imgs[0].shape)
            np.testing.assert_array_equal(fi.image, res.aligned.numpy())
        dy, dx = g[C.RES_OFFSET]
        # the card holds the f64 value to its printed digits
        assert fi.header.get_f64("CRPIX1") == pytest.approx(80.5 + i - dx,
                                                            abs=1e-9)
        assert fi.header.get_f64("CRPIX2") == pytest.approx(70.25 - i - dy,
                                                            abs=1e-9)
        for key in ("CRPIX1", "CRPIX2"):
            assert fi.header.get_f64(key) == pytest.approx(
                jfi.header.get_f64(key), abs=tol)


def test_detect_valid_region_matches_the_host_scan():
    rng = np.random.default_rng(9)
    for img in (np.zeros((7, 9), np.float32),
                rng.normal(0, 1, (20, 30)).astype(np.float32)):
        img[:3], img[:, -4:] = 0.0, np.nan
        img[5, 2] = 5e-7
        m = np.abs(img) > 1e-6
        ra, ca = m.any(1), m.any(0)
        want = (0, 0, 0, 0) if not ra.any() else (
            int(np.argmax(ra)), int(len(ra) - np.argmax(ra[::-1])),
            int(np.argmax(ca)), int(len(ca) - np.argmax(ca[::-1])))
        assert detect_valid_region(_t(img), 1e-6) == want


def test_crop_without_a_common_region_raises(tmp_path):
    p1 = np.zeros((32, 32), np.float32)
    p2 = np.zeros((32, 32), np.float32)
    p1[:10, :10], p2[20:, 20:] = 1.0, 1.0
    paths = [_fits(tmp_path, "p1", p1), _fits(tmp_path, "p2", p2)]
    for api, kw in ((tapi, {"device": CPU}), (japi, {})):
        with pytest.raises(Exception, match="No common valid region"):
            api.crop_channels_cmd(paths, str(tmp_path), **kw)
        with pytest.raises(Exception, match="at least 2"):
            api.align_channels_cmd(paths[:1], str(tmp_path), **kw)
        with pytest.raises(Exception, match="at least 2"):
            api.export_aligned_channels_cmd(paths[:1], str(tmp_path), **kw)
        with pytest.raises(Exception, match="No channel paths"):
            api.blend_channels_cmd([], [], str(tmp_path), **kw)


# ---- the device policy and the signatures ------------------------------------------


def _seed(h=48, w=48):
    planes = [_t(p) for p in star_rgb(h, w, n=6)]
    thelpers.insert_composite_and_orig(*planes, *(compute_image_stats(p)
                                                  for p in planes))


COMMANDS = {
    "compose_rgb_cmd": lambda p, o: tapi.compose_rgb_cmd(o, r_path=p,
                                                         g_path=p),
    "restretch_composite_cmd": lambda p, o: tapi.restretch_composite_cmd(
        o, 0, .5, 1, 0, .5, 1, 0, .5, 1),
    "clear_composite_cache_cmd": lambda p, o:
        tapi.clear_composite_cache_cmd(),
    "update_composite_channel_cmd": lambda p, o:
        tapi.update_composite_channel_cmd("r", p),
    "blend_channels_cmd": lambda p, o: tapi.blend_channels_cmd(
        [p], [{"channel_idx": 0, "r_weight": 1.0}], o),
    "align_channels_cmd": lambda p, o: tapi.align_channels_cmd([p, p], o),
    "crop_channels_cmd": lambda p, o: tapi.crop_channels_cmd([p], o),
    "export_aligned_channels_cmd": lambda p, o:
        tapi.export_aligned_channels_cmd([p, p], o),
    "calibrate_and_scnr_cmd": lambda p, o: tapi.calibrate_and_scnr_cmd(
        o, 1.0, 1.0, 1.0),
    "compute_auto_wb_cmd": lambda p, o: tapi.compute_auto_wb_cmd(),
    "reset_wb_cmd": lambda p, o: tapi.reset_wb_cmd(o),
}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_command_without_a_card_raises(tmp_path, monkeypatch, cmd):
    """With no device named and no card, each command raises before any
    work, also with the composite seeded on the CPU."""
    p = _fits(tmp_path, "in", star_rgb(48, 48, n=6)[0])
    _seed()
    keys = GLOBAL_IMAGE_CACHE.keys()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        COMMANDS[cmd](p, out)
    assert not os.path.exists(out)
    assert GLOBAL_IMAGE_CACHE.keys() == keys


@pytest.mark.parametrize("cmd", ["restretch_composite_cmd",
                                 "calibrate_and_scnr_cmd",
                                 "compute_auto_wb_cmd", "reset_wb_cmd"])
def test_composite_on_another_device_is_missing(tmp_path, cmd):
    """A composite held for the CPU is missing for another device: the
    color commands answer as JAX's do without a composite."""
    _seed()
    other = torch.device("meta")
    o = str(tmp_path)
    call = {"restretch_composite_cmd": lambda: tapi.restretch_composite_cmd(
        o, 0, .5, 1, 0, .5, 1, 0, .5, 1, device=other),
        "calibrate_and_scnr_cmd": lambda: tapi.calibrate_and_scnr_cmd(
            o, 1.0, 1.0, 1.0, device=other),
        "compute_auto_wb_cmd": lambda: tapi.compute_auto_wb_cmd(
            device=other),
        "reset_wb_cmd": lambda: tapi.reset_wb_cmd(o, device=other)}[cmd]
    with pytest.raises((CacheMiss, InvalidInput)):
        call()
    assert len(tapi.compute_auto_wb_cmd(device=CPU)) == 3


def test_compose_commands_have_the_jax_signature_plus_device():
    for name in COMMANDS:
        got = inspect.signature(getattr(tapi, name)).parameters
        want = inspect.signature(getattr(japi, name)).parameters
        assert list(got)[:-1] == list(want), name
        for p, q in zip(list(got.values())[:-1], want.values()):
            assert (p.kind, p.default) == (q.kind, q.default), (name, p)
        assert (got["device"].kind, got["device"].default) == \
            (inspect.Parameter.KEYWORD_ONLY, None)
        assert name in tapi.__all__
