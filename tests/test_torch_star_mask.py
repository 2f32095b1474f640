"""PyTorch port: the star-mask raster (K13's plain version and a mirror
of its kernel's tile cull) and the star mask against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the
JAX raster runs on its XLA route and as the Pallas kernel in interpret
mode, as tests/test_imaging.py runs them. Tolerances:

- against the sequential window paint of tests/test_imaging.py:271-294
  (numpy, every f32 operation rounded on its own): bit-equal — the form
  the CUDA kernel keeps too (chip_smoke.py holds it to this plain
  version bit for bit on the card);
- against JAX's ``_mask_kernel`` on the CPU: max abs 1e-6, the bound of
  the JAX package's own test against that oracle (test_imaging.py:307):
  XLA on the CPU contracts (px − x)² + (py − y)² to FMA (measured up to
  7.7e-7 here; ROADMAP C13). The coverage is held equal up to the pixels
  whose mask lies within 1e-6 of its 0.01 threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.imaging import star_mask as jsm
from astroburst_tpu_torch.imaging import star_mask as tsm
from astroburst_tpu_torch.imaging import star_mask_kernel as tsk

torch.set_num_threads(1)

CPU = torch.device("cpu")
WINDOW = tsk.WINDOW
TILE, HALF = tsk.TILE, tsk.HALF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def sequential_paint(h, w, xs, ys, radii, softness):
    """The per-star window paint of tests/test_imaging.py:271-294, in
    numpy f32 (softness as an f32 scalar, so every operation is f32)."""
    half = WINDOW // 2
    softness = np.float32(softness)
    mask = np.zeros((h + WINDOW, w + WINDOW), np.float32)
    wy = np.arange(WINDOW, dtype=np.float32)[:, None]
    wx = np.arange(WINDOW, dtype=np.float32)[None, :]
    for x, y, radius in zip(xs, ys, radii):
        soft_radius = radius + softness
        r2i, r2o = radius * radius, soft_radius * soft_radius
        fade = max(r2o - r2i, np.float32(1e-10))
        y0 = int(np.clip(np.round(y), 0, h))
        x0 = int(np.clip(np.round(x), 0, w))
        d2 = (x0 + wx - half - x) ** 2 + (y0 + wy - half - y) ** 2
        t = np.clip((d2 - r2i) / fade, 0.0, 1.0)
        val = np.where(d2 <= r2i, 1.0,
                       np.where(d2 <= r2o, 1.0 - t * t * (3.0 - 2.0 * t),
                                0.0))
        if radius <= 0:
            val = val * 0
        win = mask[y0:y0 + WINDOW, x0:x0 + WINDOW]
        mask[y0:y0 + WINDOW, x0:x0 + WINDOW] = np.maximum(
            win, val.astype(np.float32))
    return mask[half:half + h, half:half + w]


def _stars(rng, h, w, k, margin=10.0, zero_frac=0.0):
    xs = rng.uniform(-margin, w + margin, k).astype(np.float32)
    ys = rng.uniform(-margin, h + margin, k).astype(np.float32)
    radii = rng.uniform(0, 40, k).astype(np.float32)
    radii[rng.random(k) < zero_frac] = 0.0
    radii[0] = 0.0            # a dummy slot
    return xs, ys, radii


@pytest.mark.parametrize("h,w,k", [(128, 160, 7), (300, 200, 60),
                                   (97, 513, 25), (600, 520, 5000)])
def test_paint_mask_plain_bit_equal_to_sequential_oracle(h, w, k):
    """The shapes of tests/test_imaging.py:297, off-plane stars (up to
    60 px beyond the edges) and zero radii."""
    rng = np.random.default_rng(7)
    xs, ys, radii = _stars(rng, h, w, k, margin=60.0, zero_frac=0.1)
    want = sequential_paint(h, w, xs, ys, radii, 4.0)
    got = tsk.paint_mask(_t(xs), _t(ys), _t(radii), 4.0, h, w)
    assert got.shape == (h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _coverage_slack(mask, h, w):
    """Pixels whose mask lies within 1e-6 of the coverage threshold, as
    a fraction of the plane."""
    return float(np.sum(np.abs(np.asarray(mask) - 0.01) <= 1e-6)) / (h * w)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("lum", [False, True])
def test_mask_kernel_matches_jax(lum, use_pallas):
    """tests/test_imaging.py:331's case: 500 x 700, 300 stars, 10 %
    zero radii, positions up to 5 px off the plane; both luminance
    branches."""
    rng = np.random.default_rng(9)
    h, w, k = 500, 700, 300
    img = rng.normal(0.3, 0.05, (h, w)).astype(np.float32)
    img[100:110, 200:230] = 0.95          # above the luminance ceiling
    xs = rng.uniform(-5, w + 5, k).astype(np.float32)
    ys = rng.uniform(-5, h + 5, k).astype(np.float32)
    radii = np.where(rng.random(k) < 0.1, 0.0,
                     rng.uniform(1, 40, k)).astype(np.float32)
    jm, jc = jsm._mask_kernel(jnp.asarray(img), jnp.asarray(xs),
                              jnp.asarray(ys), jnp.asarray(radii),
                              jnp.float32(4.0), jnp.float32(0.85), lum,
                              use_pallas=use_pallas, interpret=use_pallas)
    tm, tc = tsm._mask_kernel(_t(img), _t(xs), _t(ys), _t(radii), 4.0, 0.85,
                              lum)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    assert abs(float(tc) - float(jc)) <= _coverage_slack(jm, h, w) + 1e-9
    # the plain paint underneath is the IEEE oracle's, bit for bit
    paint = tsk.paint_mask_plain(_t(xs), _t(ys), _t(radii), 4.0, h, w)
    if not lum:
        assert torch.equal(tm, paint)
    np.testing.assert_array_equal(
        paint.numpy(), sequential_paint(h, w, xs, ys, radii, 4.0))


def _cull(xs, ys, radii, softness, h, w, tile_r, tile_c):
    """csrc/star_mask.cu's cull of the 128² tile at (tile_r, tile_c), in
    numpy f32: {star: (first row, last row, first column, last column)}
    of the survivors' rectangles (the star's window, the disk's support
    box widened by one pixel, and the tile within the plane)."""
    f = np.float32
    tile_r1 = min(tile_r + TILE, h) - 1
    tile_c1 = min(tile_c + TILE, w) - 1
    kept = {}
    for s, (x, y, radius) in enumerate(zip(xs, ys, radii)):
        if not radius > 0:
            continue
        y0 = int(min(max(np.rint(y), f(0)), f(h)))
        x0 = int(min(max(np.rint(x), f(0)), f(w)))
        r_lo, r_hi = max(y0 - HALF, tile_r), min(y0 + HALF - 1, tile_r1)
        c_lo, c_hi = max(x0 - HALF, tile_c), min(x0 + HALF - 1, tile_c1)
        reach = max(radius, f(radius + f(softness)))
        if abs(y) + reach < f(2 ** 20):
            r_lo = max(r_lo, int(np.floor(f(y - reach))) - 1)
            r_hi = min(r_hi, int(np.ceil(f(y + reach))) + 1)
        if abs(x) + reach < f(2 ** 20):
            c_lo = max(c_lo, int(np.floor(f(x - reach))) - 1)
            c_hi = min(c_hi, int(np.ceil(f(x + reach))) + 1)
        if r_lo <= r_hi and c_lo <= c_hi:
            kept[s] = (r_lo, r_hi, c_lo, c_hi)
    return kept


def _raster_from_cull(xs, ys, radii, softness, h, w):
    """What the CUDA kernel does: each tile paints only the stars its cull
    keeps, each inside its rectangle. Asserts that a star the cull drops
    from a tile paints nothing there, and that a kept star paints only
    inside its rectangle."""
    out = np.zeros((h, w), np.float32)
    tiles = [(r, c) for r in range(0, h, TILE) for c in range(0, w, TILE)]
    kept = {t: _cull(xs, ys, radii, softness, h, w, *t) for t in tiles}
    for s in range(len(xs)):
        one = tsk.paint_mask_plain(_t(xs[s:s + 1]), _t(ys[s:s + 1]),
                                   _t(radii[s:s + 1]), softness, h,
                                   w).numpy()
        for t in tiles:
            painted = np.zeros((h, w), bool)
            painted[t[0]:t[0] + TILE, t[1]:t[1] + TILE] = \
                one[t[0]:t[0] + TILE, t[1]:t[1] + TILE] > 0
            if s not in kept[t]:
                assert not painted.any(), f"star {s} culled from tile {t}"
                continue
            r_lo, r_hi, c_lo, c_hi = kept[t][s]
            rect = (slice(r_lo, r_hi + 1), slice(c_lo, c_hi + 1))
            painted[rect] = False
            assert not painted.any(), f"star {s} paints outside its rect"
            out[rect] = np.maximum(out[rect], one[rect])
    return out


SM_CASES = ("half_positions", "off_plane_200", "reach_past_window",
            "dense_cluster", "single_slot", "odd_plane")


@pytest.mark.parametrize("case", [(128, 160, 7), (300, 200, 60),
                                  (97, 513, 25)] + list(SM_CASES))
def test_tile_cull_keeps_every_painting_star(case):
    """K13's conservative cull, mirrored: on the grid of
    test_paint_mask_plain_bit_equal_to_sequential_oracle and on
    chip_smoke.py's adversarial records (at 300 x 420), every star that
    changes a pixel of a tile survives that tile's cull with all those
    pixels in its rectangle, and the tiles painted from their survivors
    are the direct paint bit for bit."""
    import chip_smoke
    if isinstance(case, tuple):
        h, w, k = case
        xs, ys, radii = _stars(np.random.default_rng(7), h, w, k,
                               margin=60.0, zero_frac=0.1)
    else:
        xs, ys, radii, h, w = chip_smoke.star_mask_cases(
            np.random.default_rng(29), 300, 420, 120)[case]
    out = _raster_from_cull(xs, ys, radii, 4.0, h, w)
    want = tsk.paint_mask_plain(_t(xs), _t(ys), _t(radii), 4.0, h, w)
    assert float(want.max()) > 0.0
    np.testing.assert_array_equal(out, want.numpy())


def _star_image(shape=(128, 128), bg=0.1, seed=2):
    """tests/test_imaging.py:214-220's field."""
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, 0.005, shape)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    for cy, cx in [(40, 40), (90, 70), (60, 100)]:
        img += 0.8 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                            / (2 * 2.0 ** 2))
    return img.astype(np.float32)


@pytest.mark.parametrize("protect", [False, True])
def test_generate_star_mask_matches_jax(protect):
    """From one detection (JAX's), the masks agree at this file's
    tolerances; end to end, each package detects on its own and the
    star centroids and FWHMs differ at f32 rounding (moment sums in
    another order, tests/test_torch_star_detection.py), which moves the
    soft edges by up to a few 1e-6: held to 1e-5 there."""
    img = _star_image()
    img[100:105, 10:15] = 0.95     # bright non-star region
    jcfg = jsm.StarMaskConfig(luminance_protect=protect)
    tcfg = tsm.StarMaskConfig(luminance_protect=protect)
    jdet = jsm.detect_stars(jnp.asarray(img), jcfg.detection_sigma)
    jone = jsm.generate_star_mask_from_detection(img, jdet, jcfg)
    tone = tsm.generate_star_mask_from_detection(img, jdet, tcfg, device=CPU)
    assert tone.stars_masked == jone.stars_masked >= 3
    np.testing.assert_allclose(tone.mask.numpy(), np.asarray(jone.mask),
                               atol=1e-6, rtol=0)
    assert abs(tone.coverage_fraction - jone.coverage_fraction) <= \
        _coverage_slack(jone.mask, 128, 128) + 1e-9

    jres = jsm.generate_star_mask(img, jcfg)
    tres = tsm.generate_star_mask(img, tcfg, device=CPU)
    assert tres.stars_masked == jres.stars_masked
    np.testing.assert_allclose(tres.mask.numpy(), np.asarray(jres.mask),
                               atol=1e-5, rtol=0)
    mask = tres.mask.numpy()
    assert mask[40, 40] == pytest.approx(1.0, abs=1e-5)
    assert mask[5, 5] == 0.0


def test_paint_mask_rejects_other_devices():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="device"):
        tsk.paint_mask(meta, meta, meta, 4.0, 8, 8)
