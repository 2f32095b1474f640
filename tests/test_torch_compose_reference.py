"""The port's RGB compose (``api.compose_rgb_cmd`` and its stages on the
CPU) against the JAX package's (``astroburst_tpu.compose.rgb``,
``astroburst_tpu.alignment``) and against the benchmark's plain reference
of it (``benchmark/reference/compose.py``), a second witness, on seeded
small composites made by the benchmark's generator
(``benchmark/core/rgb_fields.py``): F444W on a grid of half the pixels,
F200W and F090W on the SW grid, NaN outside each filter's footprint, G
and B misregistered against R by a known affine. The sky holds 24 stars
and 8 galaxies: the CPU votes every pair of the kept sources' triangles,
and 60 sources would make each vote 34 220² pairs.

Against the JAX package, with tolerances, each for its reason:

- the harmonized planes: the same NaN pixels, values within 2 ulp of the
  plane's largest magnitude (C19: XLA contracts the resize's taps into
  FMAs; measured 1 ulp);
- the host chains (both float64 fits): the same method, matches and
  inliers, transforms within TRANSFORM_PX at the corners (they start
  from those harmonized planes, and the centroids sum in another order;
  measured ~5e-6 px);
- the fused chains (the port's plain versions, JAX's Pallas kernels in
  interpret mode; both float32 fits on coordinates normalised to the
  frame): the same method, matches and inliers, transforms within
  JAX_FUSED_PX at the corners (XLA and torch reduce the fit's sums in
  other orders; measured up to 7.2e-5 px);
- each warp of the port's transform against JAX's direct sampler
  (``warp_image(exact=True)``): the same NaN pixels, values within 1e-4
  of the plane's largest magnitude (the bound of
  tests/test_torch_affine.py's direct-sampler test: FMA contraction of
  the 16 taps; measured 1.2e-5). JAX's fused chain warps by its shear
  form, another interpolant, so its planes are not compared;
- ``process_rgb`` on the same aligned planes: statistics within the
  compare-count error of JAX's medians (C5, range / 8⁶) and 1e-6 of the
  range; the STF parameters within 1e-4; the balanced planes within the
  white-balance factors' relative difference (ratios of those medians)
  plus 1e-6 of their largest magnitude; the stretched planes within the
  normalised input's change through the MTF's steepest slope, plus 5e-4,
  four times that after SCNR (``tests/test_torch_compose.py``'s bounds);
- ``process_rgb`` with its alignment: the offsets within TRANSFORM_PX,
  the dimensions and dimension info equal, SCNR applied in both.

Both star routes are held to the reference: the host chain, which
``process_rgb`` takes on the CPU (``takes_fused_chain`` holds only on the
card), and the fused chain (``fused_chain.align_and_warp_many``) on CPU
tensors, which runs its plain versions.

Held exactly: the harmonized planes; the detected star lists (the same
exact order statistics, fills and moments in the same order); each warp
given the same transform; the colour stages on the same aligned planes
(the statistics but the mean, the balanced planes, the stretched and
SCNR'd planes and the preview's pixels); the response's dimensions and
dimension info.

With tolerances, each for its reason:

- the transforms: within TRANSFORM_PX at the frame's corners. The
  reference fits in float64 on raw pixels; the host chain does too, with
  other solvers (its gap is ~1e-9 px), and the fused chain in float32 on
  coordinates normalised to the frame (measured ~4e-5 px here);
- against the injected truth: within TRUTH_PX at the corners. The
  chain's centroids of undersampled stars, galaxies cut by the footprint
  and blends lie up to ~1 px off the rendered centres (measured
  0.75 px): this bounds the chain, not the port;
- the mean: within 1e-6 relative. The port sums the plane with the
  invalid pixels zeroed, the reference only the valid ones: the same
  terms in another order. No later stage reads it;
- the composite of the whole command: its planes within 1e-3 sigma on
  average over the pixels finite in both, and at most 0.1% of pixels
  more than a sigma off or finite in one only; the preview's values at
  most one level off on 1% of them. The host chain's transform and the
  reference's round to float32 parameters that may differ in the last
  bit, which moves a warped pixel by ~1e-7 of its value and a NaN edge
  where a tap lands within that of an integer.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from astroburst_tpu import dtypes as jd
from astroburst_tpu.alignment import affine as ja
from astroburst_tpu.alignment import fused_chain as JFC
from astroburst_tpu.compose import rgb as jrgb
from astroburst_tpu_torch import api
from astroburst_tpu_torch import dtypes as td
from astroburst_tpu_torch.api.common import load_cached_many
from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.alignment import affine as ta
from astroburst_tpu_torch.alignment import fused_chain as FC
from astroburst_tpu_torch.compose import rgb as trgb
from astroburst_tpu_torch.dtypes import (RgbComposeConfig, ScnrConfig,
                                         WhiteBalance)
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
from benchmark.core import rgb_fields as F
from benchmark.reference import compose as ref
from benchmark.reference.fits_image import read_sci_image, write_sci_image
from benchmark.reference.png import decode_png
from tests.test_torch_compose import (_factors, _stats_close, _stf_close,
                                      _stretched_close)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"sw_height": 384, "sw_width": 192, "lw_height": 192,
        "lw_width": 96, "stars": 24, "galaxies": 8, "margin_px": 16,
        "nebula_sigma_px": 60.0, "window_px": 12.0}
SEEDS = [3_000_000_019, 2_300_000_101]
TRANSFORM_PX = 1e-4
JAX_FUSED_PX = 5e-4
ULP1 = float(np.spacing(np.float32(1.0)))
TRUTH_PX = 1.5
PARAMS = dict(align=True, align_method="affine", wb_mode="auto",
              auto_stretch=True, linked_stf=False, scnr_enabled=True,
              scnr_method="average", scnr_amount=1.0)


@pytest.fixture(autouse=True)
def _clear_port_cache():
    GLOBAL_IMAGE_CACHE.clear()
    yield
    GLOBAL_IMAGE_CACHE.clear()


def _data():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "nircam-rgb-swlw.json")) as f:
        config = json.load(f)
    config["data"].update(TINY)
    return config


def _composite(seed):
    """(config, {channel: plane}, {channel: true transform})."""
    config = _data()
    planes, truth = F.render(config["data"], seed, CPU)
    return config, planes, truth


def _files(tmp_path, config, planes):
    paths = {}
    for c, p in planes.items():
        primary, sci = F.fits_cards(config, c)
        paths[c] = str(tmp_path / f"{c}.fits")
        write_sci_image(paths[c], p.numpy(), primary, sci)
    return paths


def _corner_gap(t, u, rows, cols):
    gap = 0.0
    for x, y in ((0, 0), (cols - 1, 0), (0, rows - 1), (cols - 1, rows - 1)):
        gap = max(gap, math.hypot(
            t[0] * x + t[1] * y + t[2] - (u[0] * x + u[1] * y + u[2]),
            t[3] * x + t[4] * y + t[5] - (u[3] * x + u[4] * y + u[5])))
    return gap


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _harmonized(planes):
    r, g, b, rows, cols, info = trgb.harmonize_dimensions(
        planes["r"], planes["g"], planes["b"])
    return r, g, b, rows, cols, info


@pytest.mark.parametrize("seed", SEEDS)
def test_files_read_back_and_footprints(seed, tmp_path):
    """The written files are the rendered planes, as the SCI extension
    the port selects; NaN outside each footprint, finite inside."""
    config, planes, _ = _composite(seed)
    paths = _files(tmp_path, config, planes)
    for c, p in planes.items():
        back, head = read_sci_image(paths[c])
        assert _bits(torch.from_numpy(back), p)
        assert head["EXTNAME"] == "SCI" and head["INSTRUME"] == "NIRCAM"
        inside = F.footprint(config["data"], F._channel(config["data"], c),
                             CPU)
        assert not torch.isfinite(p[~inside]).any()
        assert torch.isfinite(p[inside]).all()
        got = load_cached_many([paths[c]], device=CPU)[0].image
        assert _bits(got, p)
    assert tuple(planes["r"].shape) == (192, 96)
    assert tuple(planes["g"].shape) == tuple(planes["b"].shape) == (384, 192)


@pytest.mark.parametrize("seed", SEEDS)
def test_harmonize_and_detection_are_the_references(seed):
    _, planes, _ = _composite(seed)
    r, g, b, rows, cols, info = _harmonized(planes)
    rr, rg, rb, rrows, rcols, resampled = ref.harmonize(
        planes["r"], planes["g"], planes["b"])
    assert (rows, cols) == (rrows, rcols) == (384, 192)
    assert info.resampled and resampled
    assert _bits(r, rr) and _bits(g, rg) and _bits(b, rb)
    for plane in (r, g, b):
        xy, n = FC._detect_device(plane, 1024)
        xs, ys = ref.detect(plane)
        assert int(n) == len(xs) > 15
        assert np.array_equal(xy[0, :len(xs)].numpy(),
                              xs.astype(np.float32))
        assert np.array_equal(xy[1, :len(ys)].numpy(),
                              ys.astype(np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_both_star_routes_match_the_reference(seed, monkeypatch):
    """The host chain (``align_rgb_channels`` on the CPU) and the fused
    chain on CPU tensors: the reference's transform within TRANSFORM_PX
    at the corners, the truth within TRUTH_PX, both targets by stars,
    and each warp bit-equal to the reference's warp of the port's
    transform."""
    _, planes, truth = _composite(seed)
    r, g, b, rows, cols, _ = _harmonized(planes)
    stars = ref.detect(r)
    want = {c: ref.align(stars, ref.detect(p), rows, cols, CPU)
            for c, p in (("g", g), ("b", b))}
    host = [ta.align_channel_affine(r, p) for p in (g, b)]
    fused = FC.align_and_warp_many(r, [g, b])
    for c, plane, h, (warped, f) in zip("gb", (g, b), host, fused):
        assert want[c]["method"] == h.method == f.method == "affine"
        for res in (h, f):
            t = res.transform.as_tuple()
            assert _corner_gap(t, want[c]["transform"], rows, cols) \
                <= TRANSFORM_PX
            assert _corner_gap(t, truth[c], rows, cols) <= TRUTH_PX
        assert (h.matched_stars, h.inliers) == (want[c]["matched"],
                                                want[c]["inliers"])
        assert _bits(warped, ref.warp(plane, f.transform.as_tuple(), rows,
                                      cols))
        assert _bits(ta.warp_image(plane, h.transform, rows, cols),
                     ref.warp(plane, h.transform.as_tuple(), rows, cols))


@pytest.mark.parametrize("seed", SEEDS)
def test_colour_stages_are_the_references(seed):
    """``process_rgb`` without alignment on aligned planes: the six
    statistics (the mean within 1e-6), the balanced and stretched planes
    and the preview's pixels, against ``reference.color``."""
    _, planes, _ = _composite(seed)
    r, g, b, rows, cols, _ = _harmonized(planes)
    warped = [w for w, _ in FC.align_and_warp_many(r, [g, b])]
    config = RgbComposeConfig(white_balance=WhiteBalance(), align=False,
                              auto_stretch=True, linked_stf=False,
                              scnr=ScnrConfig(amount=1.0))
    got = trgb.process_rgb(r, *warped, config)
    want = ref.color(r, *warped, 1.0)
    for st, ws in ((got.stats_r, want["stats"][0]),
                   (got.stats_g, want["stats"][1]),
                   (got.stats_b, want["stats"][2]),
                   (got.stats_wb_r, want["stats_wb"][0]),
                   (got.stats_wb_g, want["stats_wb"][1]),
                   (got.stats_wb_b, want["stats_wb"][2])):
        for k in ("min", "max", "median", "mad", "sigma"):
            assert getattr(st, k) == ws[k], k
        assert st.mean == pytest.approx(ws["mean"], rel=1e-6)
    for p, w in zip((got.pre_stretch_r, got.pre_stretch_g,
                     got.pre_stretch_b), want["planes"]):
        assert _bits(p, w)
    for p, w in zip((got.r, got.g, got.b), want["stretched"]):
        assert _bits(p, w)
    for p, s in zip((got.stf_r, got.stf_g, got.stf_b), want["stf"]):
        assert (p.shadow, p.midtone, p.highlight) == (
            s["shadow"], s["midtone"], s["highlight"])
    u8 = torch.stack([ref.to_u8(p) for p in (got.r, got.g, got.b)], -1)
    assert torch.equal(u8, want["preview"])


@pytest.mark.parametrize("seed", SEEDS)
def test_compose_command_matches_the_reference(seed, tmp_path):
    """``compose_rgb_cmd`` on the three files (the host chain on the CPU)
    against ``reference.compose`` of the files as the benchmark reads
    them."""
    config, planes, truth = _composite(seed)
    paths = _files(tmp_path, config, planes)
    res = api.compose_rgb_cmd(str(tmp_path / "out"), r_path=paths["r"],
                              g_path=paths["g"], b_path=paths["b"],
                              device=CPU, **PARAMS)
    read = [torch.from_numpy(read_sci_image(paths[c])[0]) for c in "rgb"]
    want = ref.compose(*read, "f32", 1.0)
    assert res[C.RES_DIMENSIONS] == want["dimensions"] == [192, 384]
    assert res[C.RESAMPLED] and want["resampled"]
    info = res[C.RES_DIMENSION_INFO]
    assert tuple(info["target"]) == (192, 384)
    assert tuple(info["original_r"]) == (96, 192)
    assert res[C.RES_SCNR_APPLIED]
    for c in ("g", "b"):
        off = res[C.RES_OFFSET_G if c == "g" else C.RES_OFFSET_B]
        t = want[c]["transform"]
        assert abs(off[0] - t[5]) <= TRANSFORM_PX
        assert abs(off[1] - t[2]) <= TRANSFORM_PX
    for k, w in zip((C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G,
                     C.COMPOSITE_ORIG_B), want["planes"]):
        e = GLOBAL_IMAGE_CACHE.get(k, CPU)
        sigma = e.stats.sigma
        both = torch.isfinite(e.image) & torch.isfinite(w)
        assert float((e.image - w).abs()[both].mean()) <= 1e-3 * sigma
        off = ~both & (torch.isfinite(e.image) | torch.isfinite(w))
        off |= both & ((e.image - w).abs() > sigma)
        assert float(off.double().mean()) <= 1e-3
    png = decode_png(res[C.RES_PNG_PATH]).astype(np.int64)
    prev = want["preview"].numpy().astype(np.int64)
    assert png.shape == prev.shape
    assert np.abs(png - prev).max() <= 1 or \
        (np.abs(png - prev) > 1).mean() <= 0.01


# ---- the JAX package ------------------------------------------------------


def _jax_configs(align):
    """The benchmark's compose parameters as the port's and JAX's
    configs: auto white balance, unlinked auto-STF, SCNR average 1.0."""
    t = RgbComposeConfig(white_balance=WhiteBalance(), align=align,
                         align_method=td.AlignMethod.AFFINE,
                         auto_stretch=True, linked_stf=False,
                         scnr=ScnrConfig(amount=1.0))
    j = jd.RgbComposeConfig(white_balance=jd.WhiteBalance(), align=align,
                            align_method=jd.AlignMethod.AFFINE,
                            auto_stretch=True, linked_stf=False,
                            scnr=jd.ScnrConfig(jd.ScnrMethod.AVERAGE_NEUTRAL,
                                               1.0, False))
    return t, j


def _same_chain(a, b):
    return (a.method, a.matched_stars, a.inliers) == \
        (b.method, b.matched_stars, b.inliers)


@pytest.mark.parametrize("seed", SEEDS)
def test_harmonize_is_jax(seed):
    _, planes, _ = _composite(seed)
    r, g, b, rows, cols, info = _harmonized(planes)
    jr, jg, jb, jrows, jcols, jinfo = jrgb.harmonize_dimensions(
        *(planes[c].numpy() for c in "rgb"))
    assert (rows, cols) == (jrows, jcols) == (384, 192)
    assert info.to_dict() == jinfo.to_dict()
    assert _bits(g, torch.from_numpy(np.asarray(jg)))
    assert _bits(b, torch.from_numpy(np.asarray(jb)))
    jr = np.asarray(jr)
    assert np.array_equal(np.isnan(r.numpy()), np.isnan(jr))
    top = float(np.nanmax(np.abs(jr)))
    assert np.nanmax(np.abs(r.numpy() - jr)) <= 2 * ULP1 * top


@pytest.mark.parametrize("seed", SEEDS)
def test_star_routes_are_jax(seed):
    """The host chain against JAX's host chain, the fused chain against
    JAX's fused chain, and each port warp against JAX's direct
    sampler."""
    _, planes, truth = _composite(seed)
    r, g, b, rows, cols, _ = _harmonized(planes)
    jr = np.asarray(jrgb.harmonize_dimensions(
        *(planes[c].numpy() for c in "rgb"))[0])
    fused = FC.align_and_warp_many(r, [g, b])
    jfused = JFC.align_and_warp_many(jr, [g.numpy(), b.numpy()])
    for c, plane, (warped, f), (_, jf) in zip("gb", (g, b), fused, jfused):
        h = ta.align_channel_affine(r, plane)
        jh = ja.align_channel_affine(jr, plane.numpy())
        assert h.method == f.method == "affine"
        assert _same_chain(h, jh) and _same_chain(f, jf)
        assert _corner_gap(h.transform.as_tuple(), jh.transform.as_tuple(),
                           rows, cols) <= TRANSFORM_PX
        assert _corner_gap(f.transform.as_tuple(), jf.transform.as_tuple(),
                           rows, cols) <= JAX_FUSED_PX
        assert _corner_gap(f.transform.as_tuple(), truth[c], rows,
                           cols) <= TRUTH_PX
        want = np.asarray(ja.warp_image(
            plane.numpy(), ja.AffineTransform(*f.transform.as_tuple()),
            rows, cols, exact=True))
        got = warped.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        top = float(np.nanmax(np.abs(want)))
        assert np.nanmax(np.abs(got - want)) <= 1e-4 * top


@pytest.mark.parametrize("seed", SEEDS)
def test_colour_stages_are_jax(seed):
    """``process_rgb`` without alignment on the port's aligned planes,
    against JAX's on the same planes."""
    _, planes, _ = _composite(seed)
    r, g, b, rows, cols, _ = _harmonized(planes)
    warped = [w for w, _ in FC.align_and_warp_many(r, [g, b])]
    tcfg, jcfg = _jax_configs(align=False)
    got = trgb.process_rgb(r, *warped, tcfg)
    want = jrgb.process_rgb(r.numpy(), *(w.numpy() for w in warped), jcfg)
    wb_t = _factors(tcfg, (got.stats_r, got.stats_g, got.stats_b))
    wb_j = _factors(tcfg, (want.stats_r, want.stats_g, want.stats_b))
    wb_rel = max(abs(x / y - 1.0) for x, y in zip(wb_t, wb_j))
    for n in "rgb":
        _stats_close(getattr(got, f"stats_{n}"), getattr(want, f"stats_{n}"),
                     n)
        _stats_close(getattr(got, f"stats_wb_{n}"),
                     getattr(want, f"stats_wb_{n}"), n, wb_rel + 1e-6)
        _stf_close(getattr(got, f"stf_{n}"), getattr(want, f"stf_{n}"))
        p = getattr(got, f"pre_stretch_{n}").numpy()
        jp = np.asarray(getattr(want, f"pre_stretch_{n}"))
        assert np.array_equal(np.isnan(p), np.isnan(jp)), n
        fin = np.isfinite(jp)
        top = float(np.abs(jp[fin]).max())
        assert (np.abs(p - jp)[fin] <= (wb_rel * np.abs(jp)
                                        + 1e-6 * top)[fin]).all(), n
        _stretched_close(getattr(got, n).numpy(), np.asarray(getattr(
            want, n)), p, jp, getattr(got, f"stf_{n}"),
            getattr(got, f"stats_wb_{n}"), getattr(want, f"stf_{n}"),
            getattr(want, f"stats_wb_{n}"), True)
    assert got.scnr_applied and want.scnr_applied


@pytest.mark.parametrize("seed", SEEDS)
def test_process_rgb_is_jax(seed):
    """The whole ``process_rgb`` with its alignment (the host chain on
    the CPU in both packages): offsets, dimensions, SCNR."""
    _, planes, _ = _composite(seed)
    tcfg, jcfg = _jax_configs(align=True)
    got = trgb.process_rgb(planes["r"], planes["g"], planes["b"], tcfg)
    want = jrgb.process_rgb(*(planes[c].numpy() for c in "rgb"), jcfg)
    assert (got.rows, got.cols) == (want.rows, want.cols) == (384, 192)
    assert got.dimension_info.to_dict() == want.dimension_info.to_dict()
    for o, jo in ((got.offset_g, want.offset_g),
                  (got.offset_b, want.offset_b)):
        assert np.abs(np.subtract(o, jo)).max() <= TRANSFORM_PX
    assert got.scnr_applied and want.scnr_applied
