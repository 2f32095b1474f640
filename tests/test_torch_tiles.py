"""PyTorch port: the deep-zoom tile pyramid (``render/tiles.py``)
against the JAX package's on the CPU, and the STF'd pyramids of the
reference (ROADMAP C1) against a numpy oracle, on seeded star fields
of 64² to 131 × 97 with NaN and ±inf pixels, at tile sizes 16 and 32
(so that every plane makes 3–4 levels).

Tolerances, and why:

- ``downsample_2x`` within 1 ulp of JAX's (XLA sums the four values in
  another order), and bit-equal to numpy adding them in the port's
  fixed order;
- the percentile bounds bit-equal to an ``np.partition`` oracle at the
  f32 ranks, and within 2·range/8⁶ of JAX's compare-count ones (C21);
- quantized levels equal to JAX's given equal bounds; every pyramid's
  metadata equal to JAX's; tiles compared as decoded pixels (C16),
  never as bytes: equal to JAX's given equal bounds where a value lies
  more than 1e-3 of a level from a rounding boundary, and within one
  level everywhere (the downsampled values differ by an ulp);
- the RGB STF pyramid and the mono STF'd pyramid against a numpy f32
  oracle of the reference's form (stats by ``tests/reference_impl``,
  the STF in f32 in the port's order): within one level, equal away
  from rounding boundaries.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from astroburst_tpu.render import tiles as jt
from astroburst_tpu_torch.render import tiles as tt
from tests.reference_impl.stats import ref_stats

torch.set_num_threads(1)


def field(h, w, seed, special=True):
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 5.0, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(12):
        cy, cx = rng.random(2) * (h, w)
        img += (rng.random() * 2000.0 * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 4.5)).astype(np.float32)
    if special:
        img[5:8, 9:12] = np.nan
        img[h - 1, 0] = np.inf
        img[0, w - 1] = -np.inf
        img[10, :4] = 0.0
    return img


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def read_png(path):
    return np.asarray(Image.open(path)).astype(np.int64)


@pytest.mark.parametrize("shape", [(64, 64), (65, 64), (64, 33), (7, 9),
                                   (1, 1), (131, 97)])
def test_downsample_2x_within_an_ulp_of_jax(shape):
    img = field(*shape, 1, special=min(shape) > 12)
    img[0, 0] = np.nan
    got = tt.downsample_2x(torch.from_numpy(img)).numpy()
    want = np.asarray(jt.downsample_2x(jnp.asarray(img)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert (np.abs(bits(got) - bits(want)) <= 1).all()
    np.testing.assert_array_equal(bits(got), bits(np_downsample_2x(img)))


def np_downsample_2x(x):
    """downsample_2x in numpy f32, the box's four values added in the
    order y0x0, y0x1, y1x0, y1x1."""
    if x.shape[0] % 2:
        x = np.concatenate([x, x[-1:]], 0)
    if x.shape[1] % 2:
        x = np.concatenate([x, x[:, -1:]], 1)
    s = c = None
    for dy in (0, 1):
        for dx in (0, 1):
            q = x[dy::2, dx::2]
            fin = np.isfinite(q)
            v, n = np.where(fin, q, np.float32(0)), fin.astype(np.float32)
            s, c = (v, n) if s is None else (s + v, c + n)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(c > 0, s / np.maximum(c, np.float32(1)),
                        np.float32(0)).astype(np.float32)


@pytest.mark.parametrize("w,h,t", [(64, 64, 16), (64, 64, 64), (65, 3, 16),
                                   (4096, 4096, 256), (5655, 2206, 256),
                                   (1, 1, 256)])
def test_num_levels_equal_jax(w, h, t):
    assert tt.compute_num_levels(w, h, t) == jt.compute_num_levels(w, h, t)


def bounds_oracle(img):
    v = img.reshape(-1)
    fin = v[np.isfinite(v)]
    v = fin[fin > 1e-7]
    if v.size == 0:
        return (float(fin.min()) if fin.size else 0.0,
                float(fin.max()) if fin.size else 1.0)
    n = np.float32(v.size)
    lo = int(min(np.floor(n * np.float32(0.001)), n - np.float32(1.0)))
    hi = int(min(np.floor(n * np.float32(0.999)), n - np.float32(1.0)))
    return float(np.partition(v, lo)[lo]), float(np.partition(v, hi)[hi])


@pytest.mark.parametrize("case", ["field", "tiny", "none_valid", "empty",
                                  "one"])
def test_percentile_bounds_exact_and_near_jax(case):
    img = {"field": field(97, 131, 2),
           "tiny": field(5, 3, 3, special=False),
           "none_valid": np.array([[0.0, -1.0], [np.nan, -5.0]], np.float32),
           "empty": np.full((3, 3), np.nan, np.float32),
           "one": np.array([[np.nan, 2.5]], np.float32)}[case]
    got = tt.percentile_bounds(torch.from_numpy(img))
    assert got == bounds_oracle(img)
    want = jt.percentile_bounds(jnp.asarray(img))
    fin = img[np.isfinite(img)]
    tol = 2.0 * (float(fin.max() - fin.min()) if fin.size else 1.0) / 8 ** 6
    assert abs(got[0] - want[0]) <= tol and abs(got[1] - want[1]) <= tol


def test_quantize_equals_jax_given_equal_bounds():
    img = field(64, 80, 4)
    lo, hi = tt.percentile_bounds(torch.from_numpy(img))
    got = tt.quantize(torch.from_numpy(img), torch.tensor(lo),
                      torch.tensor(hi)).numpy()
    want = np.asarray(jt._quantize_kernel(jnp.asarray(img), jnp.float32(lo),
                                          jnp.float32(hi)))
    np.testing.assert_array_equal(got, want)


def scaled_levels(planes, lo, hi, tile):
    """Each level's planes (numpy, from the port's downsample) scaled to
    level units, for the away-from-boundary comparison."""
    lv = [[np.asarray(p, np.float32) for p in planes]]
    n = tt.compute_num_levels(planes[0].shape[1], planes[0].shape[0], tile)
    for _ in range(1, n):
        lv.append([tt.downsample_2x(torch.from_numpy(p)).numpy()
                   for p in lv[-1]])
    inv = np.float32(255.0) / np.maximum(np.float32(hi) - np.float32(lo),
                                         np.float32(1e-10))
    return [[(p - np.float32(lo)) * inv for p in ps] for ps in lv[::-1]]


def assert_tiles_close(got_dir, want_dir, pyr, scaled, rgb):
    """Every tile of both pyramids, decoded: within one level, equal
    where the scaled value is more than 1e-3 from a .5 boundary."""
    for lv in pyr["levels"]:
        for ty in range(lv["rows"]):
            for tx in range(lv["cols"]):
                name = os.path.join(str(lv["level"]), f"{tx}_{ty}.png")
                a = read_png(os.path.join(got_dir, name))
                b = read_png(os.path.join(want_dir, name))
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= 1
                t = pyr["tile_size"]
                s = [p[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t]
                     for p in scaled[lv["level"]]]
                h, w = s[0].shape
                s = np.stack(s, -1) if rgb else s[0]
                with np.errstate(invalid="ignore"):
                    frac = np.abs(np.abs(s - np.floor(s)) - 0.5)
                far = ~np.isfinite(s) | (frac > 1e-3)
                np.testing.assert_array_equal(a[:h, :w][far], b[:h, :w][far])
                assert not a[h:].any() and not a[:, w:].any()


def _same_meta(got, want, got_dir, want_dir):
    g, w = dict(got.to_dict()), dict(want.to_dict())
    assert g.pop("base_dir") == got_dir and w.pop("base_dir") == want_dir
    assert g == w


@pytest.mark.parametrize("shape,tile", [((64, 64), 16), ((131, 97), 32),
                                        ((20, 70), 16)])
def test_mono_pyramid_matches_jax(tmp_path, monkeypatch, shape, tile):
    img = field(*shape, 5)
    bounds = tt.percentile_bounds(torch.from_numpy(img))
    monkeypatch.setattr(jt, "percentile_bounds", lambda _p: bounds)
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    got = tt.generate_tile_pyramid(torch.from_numpy(img), a,
                                   tt.TileParams(tile))
    want = jt.generate_tile_pyramid(jnp.asarray(img), b, jt.TileParams(tile))
    _same_meta(got, want, a, b)
    assert len(got.levels) >= 3
    assert_tiles_close(a, b, got.to_dict(),
                       scaled_levels([img], *bounds, tile), rgb=False)


def test_rgb_pyramid_matches_jax(tmp_path, monkeypatch):
    planes = [field(70, 90, s) for s in (6, 7, 8)]
    t = [torch.from_numpy(p) for p in planes]
    lum = 0.2126 * t[0] + 0.7152 * t[1] + 0.0722 * t[2]
    bounds = tt.percentile_bounds(lum)
    monkeypatch.setattr(jt, "percentile_bounds", lambda _p: bounds)
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    got = tt.generate_tile_pyramid_rgb(*t, a, tt.TileParams(16))
    want = jt.generate_tile_pyramid_rgb(*(jnp.asarray(p) for p in planes), b,
                                        jt.TileParams(16))
    _same_meta(got, want, a, b)
    assert_tiles_close(a, b, got.to_dict(),
                       scaled_levels(planes, *bounds, 16), rgb=True)


# --- the reference's STF'd pyramids (C1), against numpy ---------------------


def np_stf(x, stf, st):
    """imaging/stf's f32 form in numpy: (dmin, 1/range, shadow, 1/clip,
    midtone) as f32 scalars, then the MTF; invalid → 0. Returns the
    value in [0, 1] (f32)."""
    f = np.float32
    dmin, inv_r = f(st["min"]), f(1.0 / max(st["max"] - st["min"], 1e-30))
    sh, inv_c = f(stf[0]), f(1.0 / max(stf[2] - stf[0], 1e-15))
    m = f(stf[1])
    c = np.clip(((x - dmin) * inv_r - sh) * inv_c, f(0), f(1))
    with np.errstate(invalid="ignore", divide="ignore"):
        y = (m - f(1)) * c / ((f(2) * m - f(1)) * c - m)
    y = np.where(c <= 0, f(0), np.where(c >= 1, f(1), y))
    return np.where(np.isfinite(x) & (x > f(1e-7)), y, f(0)).astype(f)


def test_rgb_stf_pyramid_against_numpy(tmp_path):
    """generate_tile_pyramid_rgb_stf: each level's planes through the
    linked STF with their own stats, to u8 (tiles.rs:363-373)."""
    from astroburst_tpu_torch.api.helpers import compute_linked_stf
    from astroburst_tpu_torch.dtypes import ImageStats
    planes = [field(70, 90, s) for s in (9, 10, 11)]
    sts = [ref_stats(p) for p in planes]
    stf = compute_linked_stf(*(ImageStats(**s) for s in sts))
    a = str(tmp_path / "t")
    pyr = tt.generate_tile_pyramid_rgb_stf(
        *(torch.from_numpy(p) for p in planes), stf,
        *(ImageStats(**s) for s in sts), a, tt.TileParams(16)).to_dict()
    levels = [planes]
    for _ in range(1, len(pyr["levels"])):
        levels.append([np_downsample_2x(p) for p in levels[-1]])
    prm = (stf.shadow, stf.midtone, stf.highlight)
    for lv in pyr["levels"]:
        vals = np.stack([np_stf(p, prm, st) * np.float32(255.0) for p, st in
                         zip(levels[len(levels) - 1 - lv["level"]], sts)], -1)
        want = np.clip(np.round(vals), 0, 255).astype(np.int64)
        far = np.abs(np.abs(vals - np.floor(vals)) - 0.5) > 1e-3
        for ty in range(lv["rows"]):
            for tx in range(lv["cols"]):
                got = read_png(os.path.join(a, str(lv["level"]),
                                            f"{tx}_{ty}.png"))
                sl = np.s_[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16]
                w, f = want[sl], far[sl]
                h_, w_ = w.shape[:2]
                assert got.shape == (16, 16, 3)
                assert np.abs(got[:h_, :w_] - w).max() <= 1
                np.testing.assert_array_equal(got[:h_, :w_][f], w[f])
                assert not got[h_:].any() and not got[:, w_:].any()
