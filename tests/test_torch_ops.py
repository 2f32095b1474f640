"""PyTorch port (astroburst_tpu_torch) primitives against the JAX package.

Inputs are made with numpy from a seed and fed to both packages (the
torch side through convert.stack_from_numpy). The JAX Pallas kernels
run in interpret mode, as their own tests run them; nothing in the JAX
package changes. Tolerances:

- elementwise ops (validity mask, Catmull-Rom, shift, STF): rtol 1e-6
  (identical f32 formulas; XLA may contract to FMA);
- median/MAD: the JAX compare-count value lies within range/8**6 of
  the exact order statistic the port takes (ops/quantile.py:27-35), so
  they are held to 2·range/8**6;
- crops: bit-equal.
"""

import contextlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astroburst_tpu.imaging import stf as jstf
from astroburst_tpu.ops import fft as jfft
from astroburst_tpu.ops import masking as jmask
from astroburst_tpu.ops import resample as jres
from astroburst_tpu.ops import stats as jstats
from astroburst_tpu.ops.crop_kernel import gather_crops as jgather
from astroburst_tpu.stacking.onepass_kernel import pad_stack_aligned
from astroburst_tpu_torch import convert
from astroburst_tpu_torch.imaging import stf as tstf
from astroburst_tpu_torch.ops import fft as tfft
from astroburst_tpu_torch.ops import masking as tmask
from astroburst_tpu_torch.ops import resample as tres
from astroburst_tpu_torch.ops import stats as tstats
from astroburst_tpu_torch.ops.crop_kernel import (gather_crops,
                                                  gather_crops_plain)
from astroburst_tpu_torch.runtime import device as tdevice
from astroburst_tpu_torch.runtime import kernels as K

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _plane(rng, h=96, w=130, nan_frac=0.02):
    x = rng.normal(100, 5, (h, w)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    return x


# ---- package boundaries ----------------------------------------------------


def test_port_imports_without_jax():
    """Every module of the port imports with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import astroburst_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _imported_modules(path: Path):
    """(line, module, at module level) of every import in the file: at
    module level unless a function body holds it."""
    import ast

    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield child.lineno, a.name, not in_function
            elif isinstance(child, ast.ImportFrom) and child.module \
                    and child.level == 0:
                yield child.lineno, child.module, not in_function
            yield from walk(child, inner)

    yield from walk(ast.parse(path.read_text(), str(path)), False)


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_jax_package():
    """No module of the port and no line of chip_smoke.py imports
    ``astroburst_tpu``, ``jax``, ``bench`` or ``PIL`` (AST scan, any
    depth). ``yaml`` is imported nowhere at module level, and only inside
    function bodies of ``io/asdf.py``: PyYAML is not a package the port
    may assume, and the lazy import keeps the package importable where
    it is missing."""
    files = sorted((REPO / "astroburst_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for new in ("analysis/star_detection.py", "analysis/tile_sort_kernel.py",
                "analysis/window_kernel.py", "alignment/affine.py",
                "alignment/pair.py", "alignment/vote_kernel.py",
                "imaging/star_mask.py", "imaging/star_mask_kernel.py",
                "imaging/masked_stretch.py",
                "stacking/drizzle_gather_kernel.py", "api/__init__.py",
                "api/common.py", "api/helpers.py", "api/stacking.py",
                "api/io.py", "api/visualization.py", "api/analysis.py",
                "api/metadata.py", "api/output.py",
                "io/__init__.py", "io/asdf.py", "io/dispatcher.py",
                "io/fits_reader.py", "io/fits_writer.py", "io/header.py",
                "io/png.py", "io/prefetch.py", "metadata/__init__.py",
                "metadata/header_discovery.py", "ops/ipc.py",
                "runtime/cache.py", "runtime/config.py",
                "runtime/output.py", "runtime/progress.py",
                "api/export.py", "api/processing.py",
                "imaging/calibration_pipeline.py", "imaging/normalize.py",
                "imaging/resample.py", "stacking/calibration.py",
                "ops/normalization.py", "ops/boundary.py",
                "imaging/stretch.py", "imaging/scnr.py", "imaging/curves.py",
                "imaging/wavelet.py", "imaging/background.py",
                "imaging/psf_estimation.py", "analysis/confidence.py",
                "analysis/subframe.py", "api/psf.py", "api/compose.py",
                "compose/__init__.py", "compose/white_balance.py",
                "compose/channel_blend.py", "compose/lrgb.py",
                "compose/rgb.py", "compose/drizzle_rgb.py",
                "metadata/presets.py", "metadata/wizard.py",
                "metadata/channel_mapper.py", "parallel/mesh.py",
                "parallel/halo.py", "parallel/pipeline.py",
                "parallel/drizzle.py", "parallel/fft.py",
                "parallel/compose.py", "parallel/cube.py",
                "parallel/warp.py", "alignment/fused_chain.py",
                "native/__init__.py"):
        assert REPO / "astroburst_tpu_torch" / new in files, new
    asdf = REPO / "astroburst_tpu_torch" / "io" / "asdf.py"
    bad = []
    lazy_yaml = []
    for f in files:
        for line, mod, top in _imported_modules(f):
            root = mod.split(".")[0]
            # the card's machine has no Pillow
            if root in ("astroburst_tpu", "jax", "jaxlib", "bench", "PIL"):
                bad.append(f"{f.relative_to(REPO)}:{line} imports {mod}")
            elif root == "yaml":
                if top or f != asdf:
                    bad.append(f"{f.relative_to(REPO)}:{line} imports "
                               f"{mod}" + (" at module level" if top else ""))
                else:
                    lazy_yaml.append(line)
    assert not bad, bad
    assert lazy_yaml, "io/asdf.py parses its tree without PyYAML?"


def test_port_constants_dtypes_errors_match_jax_package():
    from astroburst_tpu import constants as jc
    from astroburst_tpu import dtypes as jd
    from astroburst_tpu import errors as je
    from astroburst_tpu_torch import constants as tc
    from astroburst_tpu_torch import dtypes as td
    from astroburst_tpu_torch import errors as te
    names = [n for n in vars(tc) if n.isupper()]
    assert {"MAD_TO_SIGMA", "PADDING_THRESHOLD", "DEFAULT_DRIZZLE_SCALE",
            "BLOCK_SIZE", "CARD_SIZE", "EVENT_STACK_PROGRESS",
            "DEFAULT_OUTPUT_MAX_BYTES", "RES_OFFSETS",
            "RES_REJECTED_PIXELS", "STAR_MASK_KEY", "HISTOGRAM_BINS_DISPLAY",
            "COMPOSITE_ORIG_R", "COMPOSITE_KEY_B", "STF_G", "RES_BIN_EDGES",
            "RES_TOTAL_PIXELS", "RES_FILTER_DETECTION", "DEFAULT_STEM",
            "PROGRESS_EVENT", "EVENT_WAVELET_PROGRESS", "PROGRESS_STEPS",
            "RES_CORRECTED_PNG", "RES_MODEL_PNG", "RES_CORRECTED_FITS",
            "RES_SAMPLE_COUNT", "RES_RMS_RESIDUAL", "RES_ITERATIONS_RUN",
            "RES_STRETCH_FACTOR", "RES_SCALES_PROCESSED",
            "RES_NOISE_ESTIMATE", "RES_SCNR_APPLIED", "RES_FRAMES",
            "DEFAULT_SCNR_AMOUNT", "RES_KERNEL_SIZE", "RES_AVERAGE_FWHM",
            "RES_AVERAGE_ELLIPTICITY", "RES_SPREAD_PIXELS", "RES_STARS_USED",
            "RES_STARS_REJECTED", "RES_KERNEL", "RES_STARS_MASKED",
            "RES_MASK_COVERAGE", "RES_FINAL_BACKGROUND", "RES_CONVERGED",
            "SUFFIX_MASKED_STRETCH", "RES_COMPOSITE_DIMS",
            "RES_CURVES_APPLIED", "RES_LEVELS_APPLIED", "RES_STF_APPLIED",
            "RES_WIDTH", "RES_HEIGHT", "MAX_DIMENSION_RATIO",
            "WB_MODE_MANUAL", "WB_MODE_NONE", "LRGB_APPLIED", "DIMENSIONS",
            "ALIGN_METHOD", "RES_STATS_R", "RES_OFFSET_G",
            "RES_DIMENSION_INFO", "RES_CHANNEL_COUNT", "RES_CONFIDENCE",
            "RES_CHANNEL", "RES_OFFSET", "RES_R_FACTOR", "RES_B_FACTOR",
            "RES_BLEND_PRESET", "RES_WB_APPLIED", "RES_CACHE_KEYS",
            "RES_PERSIST_TO_DISK"} <= set(names)
    for fn in ("wizard_aligned_key", "wizard_cropped_key"):
        assert getattr(tc, fn)("ha") == getattr(jc, fn)("ha"), fn
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n
    for name in ("AlignMethod", "AlignmentMethod", "DrizzleKernel",
                 "ScnrMethod"):
        te_, je_ = getattr(td, name), getattr(jd, name)
        assert [(m.name, m.value) for m in te_] == \
            [(m.name, m.value) for m in je_], name
        for s in (None, "", "aff", "Affine", "zncc", "none", "gaussian",
                  "lanczos", "lanczos3", "square", "phase", "max",
                  "Maximum", "average"):
            assert te_.parse(s).value == je_.parse(s).value, (name, s)
    import dataclasses
    for name in ("StackConfig", "DrizzleConfig", "ImageStats", "StfParams",
                 "AutoStfConfig", "AppConfig", "ScnrConfig", "WhiteBalance",
                 "RgbComposeConfig", "RLConfig"):
        got = dataclasses.asdict(getattr(td, name)())
        want = dataclasses.asdict(getattr(jd, name)())
        assert {k: getattr(v, "value", v) for k, v in got.items()} == \
            {k: getattr(v, "value", v) for k, v in want.items()}, name
    stats = dict(min=1.5, max=9.0, median=4.0, mad=0.5, sigma=0.7413,
                 mean=4.2, valid_count=17)
    assert td.ImageStats(**stats).to_dict() == jd.ImageStats(**stats).to_dict()
    assert td.StfParams(0.1, 0.3, 0.9).to_dict() == \
        jd.StfParams(0.1, 0.3, 0.9).to_dict()
    hist = dict(bins=[1, 2], bin_edges=[0.0, 0.5, 1.0], min=0.0, max=1.0)
    assert td.Histogram(**hist).to_dict() == jd.Histogram(**hist).to_dict()
    cfg = {"output_max_bytes": 123, "output_dir": "/x", "bogus": 1}
    assert td.AppConfig.from_dict(cfg).to_dict() == \
        jd.AppConfig.from_dict(cfg).to_dict()
    for name in ("AstroError", "FitsError", "AsdfError", "InvalidInput",
                 "Cancelled", "CacheMiss"):
        t_err, j_err = getattr(te, name), getattr(je, name)
        assert issubclass(t_err, Exception)
        assert t_err.__name__ == j_err.__name__
        assert [b.__name__ for b in t_err.__mro__] == \
            [b.__name__ for b in j_err.__mro__], name
    from astroburst_tpu.ops.window import hann_periodic as jh
    from astroburst_tpu_torch.ops.window import hann_periodic as th
    for n in (0, 1, 2, 7, 512):
        np.testing.assert_array_equal(th(n), jh(n))


def test_chip_smoke_frames_equal_bench_frames():
    import bench
    import chip_smoke
    for n, h, w, seed in ((3, 40, 56, 3), (2, 64, 48, 11)):
        np.testing.assert_array_equal(chip_smoke.make_frames(n, h, w, seed),
                                      bench.make_frames(n, h, w, seed))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    there is no CUDA device, in the repo and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_policy_and_tf32():
    assert tdevice.tf32_disabled()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdevice.cuda_device()


def test_kernel_signatures_match_sources():
    """Each ctypes signature has one argtype per parameter of its
    extern "C" entry, and every .cu entry has a signature."""
    entries = {}
    for p in K.sources():
        text = p.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = len(m.group(2).split(","))
    assert entries.keys() == K.SIGNATURES.keys()
    for name, nargs in entries.items():
        assert len(K.SIGNATURES[name]) == nargs, name
    assert len(K.source_hash()) == 16


def test_kernel_wrappers_reject_other_devices():
    from astroburst_tpu_torch.stacking.drizzle_kernel import (
        drizzle_finalize, drizzle_finalize_fused)
    meta = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        gather_crops(meta, torch.zeros(1, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), 4, 4, 1)
    with pytest.raises(ValueError, match="device"):
        drizzle_finalize_fused(meta[:1].repeat(4, 1, 1), meta[0, :, :2],
                               meta[0, :2], 1, 2, 2, 4, 3.0, 3.0, 5)
    with pytest.raises(ValueError, match="device"):
        drizzle_finalize(meta, meta, 4, 3.0, 3.0, 5)
    from astroburst_tpu_torch.stacking.drizzle_gather_kernel import (
        drizzle_gather_finalize)
    base = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        drizzle_gather_finalize(meta, base, base, meta[0, :, :4],
                                meta[0, :4], 2, 4, 3.0, 3.0, 5)


# ---- the switch to the plain versions ----------------------------------------

CARD = SimpleNamespace(is_cuda=True)   # what use_kernel reads of a tensor


def test_use_kernel_inside_and_outside_plain_versions():
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
    assert K.use_kernel(CARD, "k") and not K.use_kernel(cpu, "k")
    with K.plain_versions():
        assert not K.use_kernel(CARD, "k")
        assert not K.use_kernel(cpu, "k")
        with pytest.raises(ValueError, match="device"):
            K.use_kernel(meta, "k")
    assert K.use_kernel(CARD, "k")


def test_plain_versions_nest():
    with K.plain_versions():
        with K.plain_versions():
            assert not K.use_kernel(CARD, "k")
        assert not K.use_kernel(CARD, "k")
    assert K.use_kernel(CARD, "k")


def test_plain_versions_restores_after_an_exception():
    with pytest.raises(KeyError):
        with K.plain_versions():
            raise KeyError("inside")
    assert K.use_kernel(CARD, "k")
    with K.plain_versions():
        with pytest.raises(KeyError):
            with K.plain_versions():
                raise KeyError("nested")
        assert not K.use_kernel(CARD, "k")
    assert K.use_kernel(CARD, "k")


def _phase_correlate_stack(plain):
    from astroburst_tpu_torch.alignment.phase_correlation import (
        phase_correlate_stack)
    stack = torch.rand((3, 40, 48), generator=torch.Generator().manual_seed(5))
    return phase_correlate_stack(stack[0], stack[1:], **plain)


def _drizzle_kernel_exact(plain):
    from astroburst_tpu_torch.dtypes import DrizzleKernel
    from astroburst_tpu_torch.stacking.drizzle import _drizzle_kernel_exact
    stack = torch.rand((3, 12, 10), generator=torch.Generator().manual_seed(5))
    return _drizzle_kernel_exact(
        stack, torch.tensor([0.0, 0.3, -0.4]), torch.tensor([0.0, -0.2, 0.5]),
        2.0, 0.7, DrizzleKernel.SQUARE, 24, 20, 3.0, 3.0, 5, band_rows=8,
        **plain)


@pytest.mark.parametrize("call", [_phase_correlate_stack,
                                  _drizzle_kernel_exact])
def test_plain_keyword_enters_plain_versions(call, monkeypatch):
    """The two ``plain`` keywords left (for the benchmark's reference
    tests) run their call in ``plain_versions``, with its results."""
    want = call({})
    entered = []
    inner = K.plain_versions

    @contextlib.contextmanager
    def counted():
        entered.append(1)
        with inner():
            yield
    monkeypatch.setattr(K, "plain_versions", counted)
    call({"plain": False})
    assert entered == []
    got = call({"plain": True})
    assert entered == [1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---- masking / resample / fft ------------------------------------------------


def test_validity_mask_matches_jax(rng):
    x = rng.normal(0, 1e-7, (40, 50)).astype(np.float32)
    x[0, :5] = [np.nan, np.inf, -np.inf, 1e-7, 1.0000001e-7]
    got = tmask.validity_mask(_t(x)).numpy()
    want = np.asarray(jmask.validity_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_catmull_rom_matches_jax():
    t = np.linspace(-3, 3, 241).astype(np.float32)
    np.testing.assert_allclose(tres.catmull_rom(_t(t)).numpy(),
                               np.asarray(jres.catmull_rom(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dy,dx", [
    (0.0, 0.0), (1e-13, -1e-13), (0.0, 2.5), (-3.25, 0.0), (4.7, -6.1),
    (-0.5, 0.5), (15.0, -15.0), (120.0, 3.0), (-200.5, 0.25)])
def test_shift_bicubic_matches_jax(rng, dy, dx):
    img = _plane(rng)
    got = tres.shift_bicubic(_t(img), dy, dx).numpy()
    want = np.asarray(jres.shift_bicubic(jnp.asarray(img), dy, dx))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_shift_bicubic_batch_matches_vmap(rng):
    stack = np.stack([_plane(rng, 64, 80) for _ in range(5)])
    dys = np.float32([0.0, 1.5, -2.25, 7.0, -0.3])
    dxs = np.float32([0.0, -4.5, 0.0, 3.75, 11.2])
    got = tres.shift_bicubic_batch(_t(stack), _t(dys), _t(dxs)).numpy()
    want = np.asarray(jres.shift_bicubic_batch(
        jnp.asarray(stack), jnp.asarray(dys), jnp.asarray(dxs)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fft_helpers_match_jax(rng):
    for n in (1, 2, 3, 511, 512, 513, 2206):
        assert tfft.next_power_of_two(n) == jfft.next_power_of_two(n)
    parts = [rng.normal(0, 1, (8, 9)).astype(np.float32) for _ in range(4)]
    parts[0][0, 0] = parts[1][0, 0] = 0.0   # the ε guard
    got = tfft.cross_power(*map(_t, parts), 1e-15)
    want = jfft.cross_power(*map(jnp.asarray, parts), 1e-15)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# ---- stats / STF ---------------------------------------------------------------


def _stats_pair(x, exact_pair):
    got = [v.item() for v in tstats.stats_core(_t(x), exact_pair)]
    want = [float(v) for v in jstats.stats_core(jnp.asarray(x), exact_pair)]
    return got, want


@pytest.mark.parametrize("exact_pair", [False, True])
@pytest.mark.parametrize("shape", [(150, 173), (64, 64)])
def test_stats_core_matches_jax(rng, exact_pair, shape):
    x = rng.gamma(2.0, 40.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.03] = np.nan
    x[:3, :7] = 0.0                     # padding-level pixels are invalid
    x[5, 5] = np.inf
    got, want = _stats_pair(x, exact_pair)
    mn, mx, total, count, med, mad = got
    assert count == want[3]
    assert mn == want[0] and mx == want[1]
    assert total == pytest.approx(want[2], rel=1e-5)
    tol = 2 * (mx - mn) / 8 ** 6
    assert abs(med - want[4]) <= tol
    assert abs(mad - want[5]) <= tol
    valid = np.sort(x[np.isfinite(x) & (x > 1e-7)].astype(np.float64))
    n = valid.size
    if exact_pair:
        exact = (valid[(n + 1) // 2 - 1] + valid[n // 2]) / 2
    else:
        exact = valid[-(-n // 2) - 1]
    assert med == pytest.approx(exact, rel=1e-6)


def test_stats_core_no_valid_pixels():
    x = np.full((8, 8), np.nan, np.float32)
    x[0, 0] = 0.0
    got, want = _stats_pair(x, False)
    assert got[3] == want[3] == 0
    assert got[4] == want[4] == 0.0 and got[5] == want[5] == 0.0


def test_auto_stf_matches_jax(rng):
    cases = [(100.0, 2300.0, 120.0, 3.0, 1000), (0.0, 1.0, 0.5, 0.1, 10),
             (5.0, 5.0 + 1e-31, 5.0, 0.0, 4), (1.0, 2.0, 1.9, 0.5, 0)]
    for mn, mx, med, sig, cnt in cases:
        got = tstf.auto_stf_traced(*(torch.tensor(v, dtype=torch.float32)
                                     for v in (mn, mx, med, sig)),
                                   torch.tensor(cnt))
        want = jstf.auto_stf_traced(*(jnp.float32(v)
                                      for v in (mn, mx, med, sig)),
                                    jnp.int32(cnt))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert g.item() == pytest.approx(float(w), rel=1e-6, abs=1e-7)


def test_apply_stf_matches_jax(rng):
    """Same parameters into both appliers: f32 within 1e-6, and the u8
    preview off by at most 1 on at most 0.1% of pixels."""
    x = rng.gamma(2.0, 40.0, (180, 210)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    x[:2] = 0.0
    mn, mx, _t_, count, med, mad = tstats.stats_core(_t(x), False)
    shadow, midtone = tstf.auto_stf_traced(
        mn, mx, med, torch.clamp(mad * 1.4826, min=1e-30), count)
    p = [v.item() for v in (mn, mx, shadow, midtone)]
    jp = [jnp.float32(v) for v in p]
    for as_u8 in (False, True):
        got = tstf.apply_stf_traced(_t(x), *[torch.tensor(v) for v in p],
                                    as_u8=as_u8).numpy()
        want = np.asarray(jstf.apply_stf_traced(jnp.asarray(x), *jp,
                                                as_u8=as_u8))
        assert got.dtype == want.dtype
        if as_u8:
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- K2 crops ---------------------------------------------------------------------


@pytest.mark.parametrize("frame0", [0, 1])
def test_gather_crops_plain_matches_jax_kernel(rng, frame0):
    stack = rng.normal(0, 1, (4, 640, 1024)).astype(np.float32)
    y0s = np.int32([8, 64, 0, 128][:4 - frame0])
    x0s = np.int32([128, 0, 256, 512][:4 - frame0])
    want = np.asarray(jgather(jnp.asarray(stack), jnp.asarray(y0s),
                              jnp.asarray(x0s), 512, 512, interpret=True,
                              frame0=frame0))
    before = gather_crops.launches
    got = gather_crops(convert.stack_from_numpy(stack, CPU),
                       torch.from_numpy(y0s), torch.from_numpy(x0s),
                       512, 512, frame0=frame0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gather_crops.launches == before   # the CPU path launches nothing


@pytest.mark.parametrize("w", [2206, 2205, 2048])
@pytest.mark.parametrize("frame0", [0, 1])
def test_gather_crops_plain_matches_jax_kernel_at_bench_widths(rng, w,
                                                               frame0):
    """Aligned origins (the JAX kernel's contract) on planes as wide as
    the bench frames, an odd width and a power of two."""
    stack = rng.normal(0, 1, (4, 40, w)).astype(np.float32)
    n = 4 - frame0
    y0s = np.int32([0, 8, 32, 16][:n])
    x0s = np.int32([0, 128, (w - 512) // 128 * 128, 1024][:n])
    want = np.asarray(jgather(jnp.asarray(stack), jnp.asarray(y0s),
                              jnp.asarray(x0s), 8, 512, interpret=True,
                              frame0=frame0))
    got = gather_crops(_t(stack), torch.from_numpy(y0s),
                       torch.from_numpy(x0s), 8, 512, frame0=frame0)
    np.testing.assert_array_equal(got.numpy(), want)


def _k2_split_mirror(mem, base, shape, y0s, x0s, size_r, size_c, frame0,
                     out_base):
    """csrc/gather_crops.cu's work split on flat f32 memory: the stack
    [N, h, w] starts at element ``base`` of ``mem``, the output at
    element ``out_base`` of its own buffer (element = 4 bytes, so an
    index mod 4 is the 16-byte alignment). A warp copies one crop row:
    lanes 0..3 the scalar head before the output's first 16-byte
    boundary, lanes 4..7 the ragged tail, and piece q of the body (from
    q0 + 32 u + lane, u < 4, q0 in steps of 128) as the two aligned
    16-byte source chunks that hold it, realigned by the row's source
    alignment. Returns the crops and how often each output element was
    written; checks that every chunk read holds an element of the row."""
    _, h, w = shape
    n_out = len(y0s)
    out = np.full(out_base + n_out * size_r * size_c, np.nan, np.float32)
    writes = np.zeros(out.shape, np.int32)
    for k in range(n_out):
        y0 = min(max(int(y0s[k]), 0), h - size_r)
        x0 = min(max(int(x0s[k]), 0), w - size_c)
        for i in range(size_r):
            src = base + ((frame0 + k) * h + y0 + i) * w + x0
            dst = out_base + (k * size_r + i) * size_c
            n = size_c
            head = min((4 - dst % 4) % 4, n)
            body = (n - head) // 4
            tail_at = head + 4 * body
            tail = n - tail_at
            for lane in range(8):
                e = lane if lane < 4 else tail_at + lane - 4
                if (lane < head) if lane < 4 else (lane < 4 + tail):
                    out[dst + e] = mem[src + e]
                    writes[dst + e] += 1
            s = src + head
            sh = s % 4
            a = s - sh
            q = np.array([q0 + 32 * u + lane
                          for q0 in range(0, body, 128) for u in range(4)
                          for lane in range(32) if q0 + 32 * u + lane < body],
                         dtype=np.int64)
            if q.size == 0:
                continue
            lo = a + 4 * q
            chunks = [lo] + ([lo + 4] if sh else [])
            for c in chunks:   # each aligned chunk meets the row
                assert ((c + 3 >= src) & (c <= src + n - 1)).all()
            pair = mem[(lo[:, None] + np.arange(8))]   # lo chunk, next
            vals = pair[:, sh:sh + 4]
            idx = dst + head + 4 * q[:, None] + np.arange(4)
            out[idx] = vals
            np.add.at(writes, idx, 1)
    return (out[out_base:].reshape(n_out, size_r, size_c),
            writes[out_base:])


@pytest.mark.parametrize("w", [2206, 2205, 2048])
@pytest.mark.parametrize("size_c", [512, 509, 1])
@pytest.mark.parametrize("frame0", [0, 1])
def test_k2_split_mirror_writes_every_element_once(w, size_c, frame0):
    """The kernel's split over rows, 16-byte pieces, head and tail writes
    each output element once, with the right source value, at every
    x0 mod 4, with the stack starting at each alignment (frames 1.. of
    an odd-sized plane start 8 B off a 16-byte boundary) and the output
    at each; and the plain version equals the numpy slice there."""
    rng = np.random.default_rng(w + size_c + frame0)
    n_out, h, size_r = 8, 9, 5
    stack = rng.normal(0, 1, (n_out + frame0, h, w)).astype(np.float32)
    x0s = rng.integers(0, (w - size_c) // 128 + 1, n_out) * 128 + \
        np.arange(n_out) % 4
    x0s = np.minimum(x0s, w - size_c)
    x0s[-1] = 5 * w                       # clamped down to w - size_c
    y0s = rng.integers(-2, h - size_r + 3, n_out)   # some clamped
    want = np.stack([stack[frame0 + k,
                           min(max(y, 0), h - size_r):][:size_r,
                           min(max(x, 0), w - size_c):][:, :size_c]
                     for k, (y, x) in enumerate(zip(y0s, x0s))])
    plain = gather_crops_plain(_t(stack), torch.from_numpy(y0s),
                               torch.from_numpy(x0s), size_r, size_c,
                               frame0).numpy()
    np.testing.assert_array_equal(plain, want)
    for base in range(4):
        mem = np.concatenate([np.full(base, np.nan, np.float32),
                              stack.reshape(-1),
                              np.full(8, np.nan, np.float32)])
        for out_base in (0, 1, 3):
            got, writes = _k2_split_mirror(mem, base, stack.shape, y0s, x0s,
                                           size_r, size_c, frame0, out_base)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, want)


def test_gather_crops_plain_clamps_origins(rng):
    """Origins past the plane clamp down as jax.lax.dynamic_slice clamps
    them; negative origins clamp to 0 (the refine origins never are)."""
    stack = rng.normal(0, 1, (2, 50, 60)).astype(np.float32)
    got = gather_crops_plain(_t(stack), torch.tensor([45, -5]),
                             torch.tensor([55, -1]), 20, 30)
    want0 = jax.lax.dynamic_slice(jnp.asarray(stack[0]), (45, 55), (20, 30))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want0))
    np.testing.assert_array_equal(got[1].numpy(), stack[1, :20, :30])


# ---- convert ----------------------------------------------------------------------


def test_stack_from_numpy_plain_and_ingest_layout(rng):
    frames = rng.normal(100, 5, (3, 37, 50)).astype(np.float32)
    plain = convert.stack_from_numpy(frames, CPU)
    assert plain.dtype == torch.float32 and plain.is_contiguous()
    np.testing.assert_array_equal(plain.numpy(), frames)
    padded = pad_stack_aligned(jnp.asarray(frames))
    assert padded.shape[1:] != frames.shape[1:]
    cut = convert.stack_from_numpy(padded, CPU, true_shape=(37, 50))
    assert cut.shape == (3, 37, 50) and cut.is_contiguous()
    np.testing.assert_array_equal(cut.numpy(), frames)
    with pytest.raises(ValueError):
        convert.stack_from_numpy(frames[0], CPU)
