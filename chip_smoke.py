#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (astroburst_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (nothing is caught; any failure
exits non-zero, and so does a machine without a CUDA device):

1. device: card name and count, torch/CUDA/nvcc versions, the card's
   name and power limit from nvidia-smi; TF32 must be off;
2. build: nvcc builds every kernel of ``astroburst_tpu_torch/csrc`` for
   sm_90a, one process per source, all started together; registers,
   shared memory and spills of each kernel and the build seconds are
   printed, and a kernel that spills fails the run;
3. kernels: each CUDA kernel against its plain torch version on the
   card, at the shapes of the main paths. K1-K3 on the bench workload
   (16 frames of 5655 x 2206 f32), K3 also at zero offsets against
   sigma_clip_core (the clip-only TPU kernel's function), at
   24 x 2048^2 with offsets up to +-200 and at 1, 48 and 100 frames with
   NaN/inf pixels (every template instance of the kernel), K1 also on
   NaN/inf frames. K7 and K8 (the drizzle finalize) on one 1024-row
   band of the drizzle bench (10 x 4096^2 f32 → 8192^2: 40 candidates x
   1024 x 8192), and at 10, 30, 60 and 128 frames with NaN/inf pixels
   (every template instance);
4. main paths, each with every kernel launch counter reset just before
   and read just after: (a) ``align_stack_stretch`` on the bench
   workload and ``stack_images`` on 24 frames of 2048^2 (shifts up to
   +-200), offsets against the generator's shifts; (b) calibrate →
   drizzle → stretch: masters from 16 bias, 16 dark and 16 flat frames,
   10 calibrated lights of 4096^2 (a star field with sub-pixel dithers
   in +-2 px, rendered analytically), ``drizzle_stack`` with the
   default config (scale 2, pixfrac 0.7, square, 5 iterations: the
   exact route), stats, auto-STF and u8; offsets against the dithers.
   Then every entry point again through the plain versions on the card,
   compared with the kernel path, and both paths timed with CUDA events
   (``drizzle_stack`` as is, band 64, and ``_drizzle_kernel_exact`` at
   band 1024, as the JAX package's drizzle bench ran it);
5. report: one JSON line of per-kernel results (launches on the main
   paths, error against the plain version, kernel / plain / bound /
   library times), the card's name and power limit, and the final
   ``{"ok": true, "device": ...}`` line.

Tolerances. K1 box means: rtol 1e-5 (f32 sums in another order);
K1 min/max/count and K2 crops: exact. K3 and the combined planes: at
most max(3, 1e-5 * frames * pixels) pixels differ by more than 5e-3,
and the rejected counts by at most as many — borderline clip decisions
flip on the last ulp when the tap sums contract to FMA in another
order, and each of a pixel's values can be the one that flips. (The
JAX package's own bound, tests/test_onepass_kernel.py:36-40, is 3
pixels of 6 x 130 x 170 pixel-frames, 2.3e-5; here it is 1e-5 of the
pixel-frames.) K7, K8 and the drizzle image: bit-equal image and
rejected map (the kernel keeps the plain version's order of every sum
and cannot contract), weight map within rtol 1e-6. Offsets: within
0.1 px of the generator's integer shifts, 0.15 px of the drizzle
dithers, and 0.05 px between the kernel and plain paths. STF
parameters: within 1e-4.

Bounds: the larger of the bytes a kernel must move (each input read
once, each output written once) over 3.35 TB/s and the f32 operations
counted for it over 67 TFLOP/s (the published peaks of one H100 SXM
at 700 W). Library times: one PyTorch call computing
the same function where there is one (K1: avg_pool2d for the box
means; K2: one advanced-index gather), timed here and used nowhere in
the port.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

N_FRAMES, H, W = 16, 5655, 2206          # bench.py:43-44
BIG_N, BIG_HW, BIG_SHIFT = 24, 2048, 200  # stack_images workload
DRZ_N, DRZ_HW, DRZ_BAND = 10, 4096, 1024  # bench_ops.py:366-397
DRZ_SEED = 10
FLIP_ATOL = 5e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_shifts(n: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    """The integer shifts bench.make_frames(n, h, w, seed) applies,
    replayed from the same generator draws."""
    rng = np.random.default_rng(seed)
    rng.normal(120.0, 6.0, (h, w))
    rng.random(300)
    rng.random(300)
    rng.random(300)
    shifts = rng.integers(-12, 12, size=(n, 2))
    shifts[0] = 0
    return shifts


def wide_shift_frames(n: int, hw: int, max_shift: int, seed: int = 11):
    """n star-field frames of hw x hw, frame k = base rolled by
    shifts[k] (|shift| <= max_shift, frame 0 unshifted) plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(100.0, 5.0, (hw, hw)).astype(np.float32)
    yy = np.arange(hw, dtype=np.float32)[:, None]
    xx = np.arange(hw, dtype=np.float32)[None, :]
    for sy, sx, amp in zip(rng.uniform(20, hw - 20, 400),
                           rng.uniform(20, hw - 20, 400),
                           rng.uniform(300, 2300, 400)):
        y0, x0 = int(sy) - 8, int(sx) - 8
        base[y0:y0 + 16, x0:x0 + 16] += (amp * np.exp(
            -((yy[y0:y0 + 16] - sy) ** 2 + (xx[:, x0:x0 + 16] - sx) ** 2)
            / 5.0)).astype(np.float32)
    shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
    shifts[0] = 0
    frames = [np.roll(base, tuple(s), axis=(0, 1))
              + rng.normal(0, 2.0, (hw, hw)).astype(np.float32)
              for s in shifts]
    return frames, shifts


def make_frames(n, h, w, seed=3):
    """The bench workload of the JAX package's bench.py:make_frames
    (a star field, frame k rolled by integer shifts, plus noise): a copy,
    so this script imports nothing of that package;
    tests/test_torch_ops.py holds the two equal."""
    rng = np.random.default_rng(seed)
    base = rng.normal(120.0, 6.0, (h, w)).astype(np.float32)
    ys = rng.random(300) * (h - 40) + 20
    xs = rng.random(300) * (w - 40) + 20
    amps = 300.0 + rng.random(300) * 2000.0
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for sy, sx, amp in zip(ys, xs, amps):
        y0, y1 = max(int(sy) - 8, 0), min(int(sy) + 8, h)
        x0, x1 = max(int(sx) - 8, 0), min(int(sx) + 8, w)
        base[y0:y1, x0:x1] += (
            amp * np.exp(-((yy[y0:y1] - sy) ** 2 + (xx[:, x0:x1] - sx) ** 2)
                         / 5.0)).astype(np.float32)
    frames = []
    shifts = rng.integers(-12, 12, size=(n, 2))
    shifts[0] = 0
    for i in range(n):
        f = np.roll(base, tuple(shifts[i]), axis=(0, 1))
        f = f + rng.normal(0, 2.0, (h, w)).astype(np.float32)
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def render_stars(h, w, ys, xs, amps, dy, dx, sigma, device):
    """[h, w] f32 sum of Gaussian stars (peak amps, centres (ys + dy,
    xs + dx)), each evaluated analytically on a 15 x 15 window."""
    import torch
    r = torch.arange(-7, 8, device=device)
    cy = torch.as_tensor(ys + dy, dtype=torch.float64, device=device)
    cx = torch.as_tensor(xs + dx, dtype=torch.float64, device=device)
    iy = torch.round(cy).long()[:, None, None] + r[None, :, None]
    ix = torch.round(cx).long()[:, None, None] + r[None, None, :]
    val = torch.as_tensor(amps, dtype=torch.float64, device=device)[
        :, None, None] * torch.exp(
        -((iy - cy[:, None, None]) ** 2 + (ix - cx[:, None, None]) ** 2)
        / (2.0 * sigma * sigma))
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    img = torch.zeros(h * w, dtype=torch.float64, device=device)
    img.index_put_(((iy * w + ix)[ok],), val[ok], accumulate=True)
    return img.reshape(h, w).float()


def calibration_scene(n, hw, seed, device, n_cal=16):
    """Synthetic raw bias, dark and flat stacks (n_cal frames each) and n
    raw light frames of hw x hw: lights = bias + dark + flat * (sky +
    stars moved by sub-pixel dithers in +-2 px) + noise. Returns (bias,
    darks, flats, lights, dithers [n, 2] as (dy, dx), frame 0 at 0)."""
    import torch
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(seed)

    def noise(shape, sigma):
        return torch.randn(shape, generator=g, device=device) * sigma

    yy = torch.linspace(-1, 1, hw, device=device)[:, None]
    xx = torch.linspace(-1, 1, hw, device=device)[None, :]
    bias_true = 500.0 + 2.0 * torch.sin(yy * 40.0) + 0.0 * xx
    dark_true = 20.0 + torch.zeros(hw, hw, device=device)
    hot = torch.as_tensor(rng.integers(0, hw * hw, 2000), device=device)
    dark_true.view(-1)[hot] += 800.0
    flat_true = 1.0 - 0.3 * (yy * yy + xx * xx)
    bias = torch.stack([bias_true + noise((hw, hw), 1.5)
                        for _ in range(n_cal)])
    darks = torch.stack([bias_true + dark_true + noise((hw, hw), 1.5)
                         for _ in range(n_cal)])
    flats = torch.stack([bias_true + dark_true + 20000.0 * flat_true
                         + noise((hw, hw), 50.0) for _ in range(n_cal)])
    n_stars = max(64, hw * hw // 6000)
    ys = rng.uniform(10, hw - 10, n_stars)
    xs = rng.uniform(10, hw - 10, n_stars)
    amps = rng.uniform(200.0, 4000.0, n_stars)
    dith = rng.uniform(-2.0, 2.0, (n, 2))
    dith[0] = 0.0
    lights = torch.stack([
        bias_true + dark_true + flat_true * (
            300.0 + render_stars(hw, hw, ys, xs, amps, dy, dx, 1.6, device))
        + noise((hw, hw), 5.0) for dy, dx in dith])
    return bias, darks, flats, lights, dith


def flip_bound(n_frames: int, npix: int) -> int:
    return max(3, int(1e-5 * n_frames * npix))


def check_flips(what: str, n_frames: int, got, ref, got_rej, ref_rej):
    """K3-style comparison of planes combined from ``n_frames``
    frames; returns (max_abs_err, flips)."""
    import torch
    d = (got - ref).abs()
    both_nan = torch.isnan(got) & torch.isnan(ref)
    d = torch.where(both_nan, torch.zeros_like(d), d)
    if torch.isnan(d).any():
        raise AssertionError(f"{what}: NaN where the reference is finite")
    flips = int((d > FLIP_ATOL).sum())
    bound = flip_bound(n_frames, got.numel())
    drej = abs(int(got_rej) - int(ref_rej))
    log(f"  {what}: max|d|={float(d.max()):.3e} flips={flips} "
        f"(bound {bound}) rejected {int(got_rej)} vs {int(ref_rej)}")
    if flips > bound or drej > bound:
        raise AssertionError(f"{what}: {flips} flips / rejected off by "
                             f"{drej}, bound {bound}")
    return float(d.max()), flips


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls between CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_name(sym: str) -> str:
    """The ``*_kernel`` identifier inside a mangled symbol."""
    m = re.search(r"[a-z][a-z_]*_kernel", sym)
    return m.group(0) if m else sym


def ptxas_summary(build_log: str):
    """[(kernel, registers, smem bytes, stack bytes, spill st, spill ld)]
    from nvcc -Xptxas -v output; every entry must target sm_90a."""
    rows = []
    blocks = re.split(r"Compiling entry function ", build_log)[1:]
    for b in blocks:
        m = re.match(r"'([^']+)' for '(\w+)'", b)
        if m is None:
            continue
        sym, arch = m.groups()
        if arch != "sm_90a":
            raise AssertionError(f"{sym} compiled for {arch}, not sm_90a")
        name = _kernel_name(sym)
        tmpl = re.findall(r"L([ib])(\d+)E", sym)
        if tmpl:
            name += "<" + ",".join(v if t == "i" else ("fused", "plain")[
                v == "0"] for t, v in tmpl) + ">"
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", b)
        regs = re.search(r"Used (\d+) registers", b)
        smem = re.search(r"(\d+) bytes smem", b)
        rows.append((name, int(regs.group(1)),
                     int(smem.group(1)) if smem else 0,
                     int(stack.group(1)), int(stack.group(2)),
                     int(stack.group(3))))
    return rows


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for the work on one H100 —
    the larger of the bytes over the HBM rate and the f32 operations
    over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_finalize(what: str, got, ref) -> dict:
    """K7/K8 against the plain version: image and rejected map
    bit-equal, the weight map within rtol 1e-6."""
    import torch
    d_img = float((got[0] - ref[0]).abs().max())
    d_wgt = float((got[1] - ref[1]).abs().max())
    log(f"  {what}: image max|d|={d_img:.3e}, weights max|d|="
        f"{d_wgt:.3e}, rejected {int(got[2].sum())} vs "
        f"{int(ref[2].sum())}")
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])):
        raise AssertionError(f"{what}: image or rejected map not "
                             f"bit-equal to the plain version")
    if not torch.allclose(got[1], ref[1], rtol=1e-6, atol=0.0):
        raise AssertionError(f"{what}: weight map beyond rtol 1e-6")
    return {"max_abs_err": d_img, "weights_max_abs_err": d_wgt}


def stf_preview(img):
    """stats_core → auto-STF → u8 stretch of one plane: (stf [2], u8)."""
    import torch
    from astroburst_tpu_torch.imaging.stf import (apply_stf_traced,
                                                  auto_stf_traced)
    from astroburst_tpu_torch.ops.stats import stats_core
    mn, mx, _total, count, med, mad = stats_core(img, False)
    sigma = torch.clamp(mad * 1.4826, min=1e-30)
    shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
    return (torch.stack([shadow, midtone]),
            apply_stf_traced(img, mn, mx, shadow, midtone, as_u8=True))


def calibrate(bias, darks, flats, lights):
    """Masters from the raw stacks (the array forms of create_master_*),
    then every light calibrated."""
    from astroburst_tpu_torch.stacking import calibration as CAL
    mb = CAL.median_combine(bias)
    md = CAL.median_combine(darks - mb[None])
    mf = CAL._mean_normalize(CAL.median_combine(flats - mb[None] - md[None]))
    cfg = CAL.CalibrationConfig(master_bias=mb, master_dark=md,
                                master_flat=mf)
    return [CAL.calibrate_image(f, cfg) for f in lights]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")

    from astroburst_tpu_torch.alignment.coarse_kernel import (
        box_plan, coarse_downsample_stack, coarse_downsample_stack_plain)
    from astroburst_tpu_torch.alignment.phase_correlation import (
        REFINE_CROP_SIZE, _refine_origin)
    from astroburst_tpu_torch.convert import stack_from_numpy
    from astroburst_tpu_torch.dtypes import DrizzleConfig, DrizzleKernel
    from astroburst_tpu_torch.ops.crop_kernel import (gather_crops,
                                                      gather_crops_plain)
    from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import (cuda_device,
                                                     tf32_disabled)
    from astroburst_tpu_torch.stacking.clip import sigma_clip_core
    from astroburst_tpu_torch.stacking.combine import stack_images
    from astroburst_tpu_torch.stacking.drizzle import (
        _drizzle_kernel_exact, _frame_candidates_raw, _masked_candidates,
        _outer, drizzle_stack)
    from astroburst_tpu_torch.stacking.drizzle_kernel import (
        drizzle_finalize, drizzle_finalize_fused,
        drizzle_finalize_fused_plain, drizzle_finalize_plain)
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        shift_clip_onepass, shift_clip_onepass_plain)

    # ---- 1. device ---------------------------------------------------
    t_start = time.perf_counter()
    dev = cuda_device()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    nvcc_ver = subprocess.run([K.nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    log(f"[device] {kind} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvcc: {nvcc_ver.splitlines()[-1]}")
    log(f"[device] nvidia-smi name, power.limit: {smi}")
    if not tf32_disabled():
        raise AssertionError("TF32 is enabled")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    lib = K.library()
    log(f"[build] {lib.path.relative_to(K.BUILD_ROOT.parent.parent)}: "
        f"nvcc {lib.build_seconds:.2f} s, one process per source "
        f"(load {time.perf_counter() - t0:.2f} s)")
    rows = ptxas_summary(lib.build_log)
    for name, regs, smem, stack_b, sst, sld in rows:
        log(f"[build]   {name}: sm_90a, {regs} registers, {smem} B smem, "
            f"{stack_b} B stack, spills {sst}/{sld} B")
    built = {r[0].split("<")[0] for r in rows}
    want = {"shift_clip_kernel", "coarse_box_kernel", "gather_crops_kernel",
            "drizzle_finalize_kernel"}
    if not want <= built:
        raise AssertionError(f"kernels missing from the build: "
                             f"{want - built}")
    spills = [r[0] for r in rows if r[4] or r[5]]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    # ---- 3. kernels vs plain at the main paths' shapes -----------------
    t0 = time.perf_counter()
    frames = make_frames(N_FRAMES, H, W)
    shifts = bench_shifts(N_FRAMES, H, W)
    for k in (1, N_FRAMES - 1):  # the replayed shifts are make_frames's
        resid = frames[k] - np.roll(frames[0], tuple(shifts[k]), (0, 1))
        if float(resid[64:-64, 64:-64].std()) > 4.0:
            raise AssertionError("bench_shifts no longer replays "
                                 "make_frames")
    stack = stack_from_numpy(frames, dev)
    del frames
    big_frames, big_shifts = wide_shift_frames(BIG_N, BIG_HW, BIG_SHIFT)
    log(f"[data] bench stack {tuple(stack.shape)}, {BIG_N} frames of "
        f"{BIG_HW}^2 (made in {time.perf_counter() - t0:.1f} s)")
    report = {}
    npix = N_FRAMES * H * W

    a = coarse_downsample_stack(stack, 512, with_stats=True)
    b = coarse_downsample_stack_plain(stack, 512, with_stats=True)
    torch.cuda.synchronize()
    by, bx, ds_r, ds_c = box_plan(H, W, 512)   # 12, 5 at the bench shape
    if a[0].shape != (N_FRAMES, ds_r, ds_c) or a[1:3] != (by, bx):
        raise AssertionError(f"K1 plan {a[0].shape} {a[1:3]}")
    if not torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-6):
        raise AssertionError("K1 box means differ from the plain version")
    for x, y, what in zip(a[3:], b[3:], ("min", "max", "count")):
        if not torch.equal(x, y):
            raise AssertionError(f"K1 {what} differs")
    k1_err = float((a[0] - b[0]).abs().max())
    log(f"[K1] coarse_box {list(stack.shape)} -> {tuple(a[0].shape)}: "
        f"max|d|={k1_err:.3e}; min/max/count exact")
    region = stack[:, None, :ds_r * by, :ds_c * bx]
    k1_lib = torch.nn.functional.avg_pool2d(region, (by, bx))[:, 0]
    if not torch.allclose(k1_lib, a[0], rtol=1e-5, atol=1e-3):
        raise AssertionError("avg_pool2d is not the K1 box mean")
    report["coarse_box"] = {"max_abs_err": k1_err, "ms": cuda_ms(
        lambda: coarse_downsample_stack(stack, 512, with_stats=True), 20),
        "plain_ms": cuda_ms(lambda: coarse_downsample_stack_plain(
            stack, 512, with_stats=True), 5),
        "library_ms": cuda_ms(lambda: torch.nn.functional.avg_pool2d(
            region, (by, bx)), 20),
        "library": "torch.nn.functional.avg_pool2d (box means only)"}
    report["coarse_box"].update(zip(("bound_ms", "bound_by"), bound(
        4 * (npix + N_FRAMES * ds_r * ds_c), 3 * npix)))

    cy = torch.as_tensor(H // 2 + shifts[1:, 0], device=dev)
    cx = torch.as_tensor(W // 2 + shifts[1:, 1], device=dev)
    y0s, x0s = _refine_origin(cy, cx, H, W, REFINE_CROP_SIZE)
    c1 = gather_crops(stack, y0s, x0s, 512, 512, frame0=1)
    c2 = gather_crops_plain(stack, y0s, x0s, 512, 512, frame0=1)
    torch.cuda.synchronize()
    if not torch.equal(c1, c2):
        raise AssertionError("K2 crops differ from the plain version")
    log(f"[K2] gather_crops {N_FRAMES - 1} x 512^2 at origins "
        f"{list(zip(y0s.tolist(), x0s.tolist()))[:3]}...: bit-equal")
    fr_i = torch.arange(1, N_FRAMES, device=dev)[:, None, None]
    row_i = (y0s[:, None] + torch.arange(512, device=dev))[:, :, None]
    col_i = (x0s[:, None] + torch.arange(512, device=dev))[:, None, :]
    report["gather_crops"] = {"max_abs_err": 0.0, "ms": cuda_ms(
        lambda: gather_crops(stack, y0s, x0s, 512, 512, frame0=1), 50),
        "plain_ms": cuda_ms(lambda: gather_crops_plain(
            stack, y0s, x0s, 512, 512, frame0=1), 20),
        "library_ms": cuda_ms(lambda: stack[fr_i, row_i, col_i], 50),
        "library": "one advanced-index gather"}
    report["gather_crops"].update(zip(("bound_ms", "bound_by"), bound(
        2 * 4 * (N_FRAMES - 1) * 512 * 512, 0)))

    rng = np.random.default_rng(5)
    offs = rng.uniform(-12, 12, (2, N_FRAMES)).astype(np.float32)
    offs[:, 0] = 0.0
    dys, dxs = (torch.as_tensor(o, device=dev) for o in offs)
    got = shift_clip_onepass(stack, dys, dxs)
    ref = shift_clip_onepass_plain(stack, dys, dxs)
    torch.cuda.synchronize()
    k3_err, k3_flips = check_flips(
        f"[K3] shift_clip {N_FRAMES}x{H}x{W} +-12", N_FRAMES, got[0],
        ref[0], got[1], ref[1])
    # bytes: the stack once, the image and the rejected map; operations:
    # the 4x4 Catmull-Rom taps (32) and their 8 weights (56) per
    # pixel-frame — the data-dependent clip is not counted
    report["shift_clip"] = {"max_abs_err": k3_err, "flips": k3_flips,
                            "ms": cuda_ms(lambda: shift_clip_onepass(
                                stack, dys, dxs), 10),
                            "plain_ms": cuda_ms(
                                lambda: shift_clip_onepass_plain(
                                    stack, dys, dxs), 3),
                            "library_ms": None}
    report["shift_clip"].update(zip(("bound_ms", "bound_by"), bound(
        4 * npix + 8 * H * W, 88 * npix)))
    zeros = torch.zeros(N_FRAMES, device=dev)
    got = shift_clip_onepass(stack, zeros, zeros)
    ref = sigma_clip_core(stack)
    torch.cuda.synchronize()
    e0, f0 = check_flips(f"[K3] shift_clip at zero offsets vs "
                         f"sigma_clip_core {N_FRAMES}x{H}x{W}", N_FRAMES,
                         got[0], ref[0], got[1], ref[1])
    report["shift_clip"].update({"max_abs_err_zero_offsets": e0,
                                 "flips_zero_offsets": f0})
    big = stack_from_numpy(np.stack(big_frames), dev)
    boffs = rng.uniform(-BIG_SHIFT, BIG_SHIFT, (2, BIG_N)).astype(np.float32)
    bdys, bdxs = (torch.as_tensor(o, device=dev) for o in boffs)
    got = shift_clip_onepass(big, bdys, bdxs)
    ref = shift_clip_onepass_plain(big, bdys, bdxs)
    torch.cuda.synchronize()
    e24, f24 = check_flips(
        f"[K3] shift_clip {BIG_N}x{BIG_HW}x{BIG_HW} +-{BIG_SHIFT}", BIG_N,
        got[0], ref[0], got[1], ref[1])
    report["shift_clip"].update({
        "max_abs_err_24x2048": e24, "flips_24x2048": f24,
        "ms_24x2048": cuda_ms(lambda: shift_clip_onepass(big, bdys, bdxs),
                              10),
        "plain_ms_24x2048": cuda_ms(lambda: shift_clip_onepass_plain(
            big, bdys, bdxs), 3),
        "bound_ms_24x2048": bound(4 * BIG_N * BIG_HW ** 2 + 8 * BIG_HW ** 2,
                                  88 * BIG_N * BIG_HW ** 2)[0]})
    del big, got, ref

    # edge cases the bench frames do not reach: non-finite pixels, exact
    # zero offsets, 1 frame, and the MAXN 64/128 instances of K3; K1 on
    # NaN/inf with remainder rows and columns
    for n in (1, 48, 100):
        e = rng.normal(100, 5, (n, 300, 400)).astype(np.float32)
        e[rng.random(e.shape) < 0.01] = np.nan
        e[:, 7, 9] = np.nan
        e[: n // 2, 11, 13] = np.inf
        eoffs = rng.uniform(-30, 30, (2, n)).astype(np.float32)
        eoffs[:, 0] = 0.0
        eoffs[0, n // 3] = 0.0
        es = stack_from_numpy(e, dev)
        edys, edxs = (torch.as_tensor(o, device=dev) for o in eoffs)
        got = shift_clip_onepass(es, edys, edxs, 2.5, 3.0, 5)
        ref = shift_clip_onepass_plain(es, edys, edxs, 2.5, 3.0, 5)
        torch.cuda.synchronize()
        check_flips(f"[K3] shift_clip {n}x300x400 +-30, NaN/inf pixels",
                    n, got[0], ref[0], got[1], ref[1])
    e = rng.normal(100, 10, (3, 1030, 1100)).astype(np.float32)
    e[0, 5, 7] = np.nan
    e[1, 1029, 1099] = -5.0
    e[2, 100:110, 50:60] = np.inf
    es = stack_from_numpy(e, dev)
    a = coarse_downsample_stack(es, 512, with_stats=True)
    b = coarse_downsample_stack_plain(es, 512, with_stats=True)
    torch.cuda.synchronize()
    if not (torch.equal(torch.isfinite(a[0]), torch.isfinite(b[0]))
            and torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
            and all(torch.equal(x, y) for x, y in zip(a[3:], b[3:]))):
        raise AssertionError("K1 differs from plain on NaN/inf frames")
    log(f"[K1] coarse_box [3, 1030, 1100] with NaN/inf: non-finite boxes "
        f"{int((~torch.isfinite(a[0])).sum())}, stats exact")
    del es, got, ref

    # K7 / K8 at one band of the drizzle bench (bench_ops.py:366-397:
    # 10 x 4096^2 f32, offsets in +-2, scale 2, pixfrac 0.7, square,
    # 5 iterations → 2 x 2 taps, 40 candidates x 1024 x 8192)
    t0 = time.perf_counter()
    drng = np.random.default_rng(DRZ_SEED)
    gen = torch.Generator(device=dev).manual_seed(DRZ_SEED)
    dstack = torch.randn((DRZ_N, DRZ_HW, DRZ_HW), generator=gen,
                         device=dev) * 8.0 + 100.0
    dd_ys = torch.as_tensor(drng.uniform(-2, 2, DRZ_N), dtype=torch.float32,
                            device=dev)
    dd_xs = torch.as_tensor(drng.uniform(-2, 2, DRZ_N), dtype=torch.float32,
                            device=dev)
    out_hw = 2 * DRZ_HW
    r0 = 3 * DRZ_BAND   # the fourth band: r0/scale = 1536 in f32
    cand, wys, wxs, taps = _frame_candidates_raw(
        dstack, dd_ys - r0 / 2.0, dd_xs, 2.0, 0.7, DrizzleKernel.SQUARE,
        DRZ_BAND, out_hw)
    wys_t = wys.T.contiguous()
    m = cand.shape[0]
    cap = max(2 * DRZ_N, 4)
    fin_args = (DRZ_N, taps, taps, cap, 3.0, 3.0, 5)
    got = drizzle_finalize_fused(cand, wys_t, wxs, *fin_args)
    ref = drizzle_finalize_fused_plain(cand, wys_t, wxs, *fin_args)
    torch.cuda.synchronize()
    log(f"[data] drizzle bench stack {tuple(dstack.shape)}, band "
        f"{tuple(cand.shape)} (made in {time.perf_counter() - t0:.1f} s)")
    report["drizzle_finalize_fused"] = check_finalize(
        f"[K7] drizzle_finalize_fused {tuple(cand.shape)}", got, ref)
    band_px = DRZ_BAND * out_hw
    report["drizzle_finalize_fused"].update({
        "ms": cuda_ms(lambda: drizzle_finalize_fused(cand, wys_t, wxs,
                                                     *fin_args), 10),
        "plain_ms": cuda_ms(lambda: drizzle_finalize_fused_plain(
            cand, wys_t, wxs, *fin_args), 2),
        "library_ms": None,
        "shape": list(cand.shape)})
    # bytes: candidates, both weight tables, three output planes;
    # operations: w = wy·wx per candidate and the weight sum
    report["drizzle_finalize_fused"].update(zip(("bound_ms", "bound_by"),
                                                bound(
        4 * (m * band_px + wys_t.numel() + wxs.numel()) + 12 * band_px,
        2 * m * band_px)))
    cand_v, cand_w = _masked_candidates(cand, _outer(
        wys.reshape(DRZ_N, taps, DRZ_BAND), wxs.reshape(DRZ_N, taps, out_hw)))
    got = drizzle_finalize(cand_v, cand_w, cap, 3.0, 3.0, 5)
    ref = drizzle_finalize_plain(cand_v, cand_w, cap, 3.0, 3.0, 5)
    torch.cuda.synchronize()
    report["drizzle_finalize"] = check_finalize(
        f"[K8] drizzle_finalize {tuple(cand_v.shape)}", got, ref)
    k7_ref = drizzle_finalize_fused_plain(cand, wys_t, wxs, *fin_args)
    if not all(torch.equal(x, y) for x, y in zip(ref, k7_ref)):
        raise AssertionError("K8 and K7 plain versions differ on the "
                             "same candidates")
    report["drizzle_finalize"].update({
        "ms": cuda_ms(lambda: drizzle_finalize(cand_v, cand_w, cap, 3.0,
                                               3.0, 5), 10),
        "plain_ms": cuda_ms(lambda: drizzle_finalize_plain(
            cand_v, cand_w, cap, 3.0, 3.0, 5), 2),
        "library_ms": None,
        "shape": list(cand_v.shape)})
    report["drizzle_finalize"].update(zip(("bound_ms", "bound_by"), bound(
        8 * m * band_px + 12 * band_px, m * band_px)))
    del cand, cand_v, cand_w, got, ref, k7_ref

    # NaN/inf pixels at every template size of the finalize kernel:
    # min(cap, m) = 2n at 2 x 2 taps → 20, 60, 120, 256 (CAPMAX 32, 64,
    # 128, 256); K8 gets the raw non-finite values at weight 0
    for n in (10, 30, 60, 128):
        e = rng.normal(100, 8, (n, 40, 72)).astype(np.float32)
        e[rng.random(e.shape) < 0.02] = np.nan
        e[: n // 2, 5, 9] = np.inf
        e[1, 20, 30] = -np.inf
        e[2, 10, 10] = 5000.0
        es = stack_from_numpy(e, dev)
        ed = [torch.as_tensor(rng.uniform(-2, 2, n), dtype=torch.float32,
                              device=dev) for _ in range(2)]
        cand, wys, wxs, taps = _frame_candidates_raw(
            es, ed[0], ed[1], 2.0, 1.0, DrizzleKernel.SQUARE, 80, 144)
        args = (n, taps, taps, max(2 * n, 4), 2.5, 3.0, 5)
        wys_t = wys.T.contiguous()
        check_finalize(f"[K7] {tuple(cand.shape)}, NaN/inf pixels",
                       drizzle_finalize_fused(cand, wys_t, wxs, *args),
                       drizzle_finalize_fused_plain(cand, wys_t, wxs, *args))
        _, cand_w = _masked_candidates(cand, _outer(
            wys.reshape(n, taps, 80), wxs.reshape(n, taps, 144)))
        check_finalize(f"[K8] {tuple(cand.shape)}, NaN/inf at weight 0",
                       drizzle_finalize(cand, cand_w, *args[3:]),
                       drizzle_finalize_plain(cand, cand_w, *args[3:]))
    del es, cand, cand_w, dstack

    # ---- 4a. main paths of the earlier slice, through the kernels ------
    counters = {"shift_clip": shift_clip_onepass,
                "coarse_box": coarse_downsample_stack,
                "gather_crops": gather_crops,
                "drizzle_finalize_fused": drizzle_finalize_fused,
                "drizzle_finalize": drizzle_finalize}
    big_list = [torch.as_tensor(f, device=dev) for f in big_frames]
    del big_frames
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = align_stack_stretch(stack)
    res = stack_images(big_list)
    torch.cuda.synchronize()
    launches_stack = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in align_stack_stretch + stack_images: "
        f"{launches_stack}")
    for name in ("shift_clip", "coarse_box", "gather_crops"):
        if launches_stack[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_stack}")

    comb = out["combined"]
    if comb.shape != (H, W) or not bool(torch.isfinite(comb).all()):
        raise AssertionError("combined plane is not finite [H, W]")
    if out["preview"].dtype != torch.uint8 or out["preview"].shape != (H, W):
        raise AssertionError("preview is not u8 [H, W]")
    off = out["offsets"].cpu().numpy()
    off_err = float(np.abs(off - shifts).max())
    log(f"[path] align_stack_stretch offsets vs generator: max|d|="
        f"{off_err:.4f} px; rejected {int(out['rejected'])}; stf "
        f"{out['stf'].tolist()}")
    if off_err > 0.1:
        raise AssertionError(f"offsets off by {off_err} px: {off.tolist()}")
    if [list(o) for o in res.offsets] != big_shifts.tolist():
        raise AssertionError(f"stack_images offsets {res.offsets} != "
                             f"{big_shifts.tolist()}")
    if not bool(torch.isfinite(res.image).all()):
        raise AssertionError("stack_images image is not finite")
    log(f"[path] stack_images {BIG_N}x{BIG_HW}^2: offsets match the "
        f"generator (+-{BIG_SHIFT}); rejected {res.rejected_pixels}")

    # the same entry points through the plain versions on the card
    out_p = align_stack_stretch(stack, plain=True)
    res_p = stack_images(big_list, plain=True)
    torch.cuda.synchronize()
    d_off = float((out["offsets"] - out_p["offsets"]).abs().max())
    d_stf = float((out["stf"] - out_p["stf"]).abs().max())
    log(f"[path] kernel vs plain: offsets max|d|={d_off:.2e}, stf "
        f"max|d|={d_stf:.2e}")
    if d_off > 0.05 or d_stf > 1e-4:
        raise AssertionError("kernel path and plain path disagree")
    check_flips("[path] align_stack_stretch combined", N_FRAMES, comb,
                out_p["combined"], out["rejected"], out_p["rejected"])
    if res.offsets != res_p.offsets:
        raise AssertionError("stack_images offsets differ from plain")
    check_flips("[path] stack_images image", BIG_N, res.image, res_p.image,
                res.rejected_pixels, res_p.rejected_pixels)
    del out_p, res_p

    mpx = npix / 1e6
    torch.cuda.reset_peak_memory_stats()
    ms_k = cuda_ms(lambda: align_stack_stretch(stack), 10)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_p = cuda_ms(lambda: align_stack_stretch(stack, plain=True), 3)
    peak_p = torch.cuda.max_memory_allocated()
    ms_s = cuda_ms(lambda: stack_images(big_list), 3)
    ms_sp = cuda_ms(lambda: stack_images(big_list, plain=True), 2)
    log(f"[time] {smi}: align_stack_stretch {N_FRAMES}x{H}x{W} kernels "
        f"{ms_k:.3f} ms ({mpx / ms_k * 1e3:.1f} Mpx/s, peak "
        f"{peak_k / 2**30:.2f} GiB) | plain {ms_p:.3f} ms "
        f"({mpx / ms_p * 1e3:.1f} Mpx/s, peak {peak_p / 2**30:.2f} GiB)")
    log(f"[time] {smi}: stack_images {BIG_N}x{BIG_HW}^2 kernels {ms_s:.3f} ms | "
        f"plain {ms_sp:.3f} ms (host offsets fetch included)")
    del stack, big_list, out, res, comb

    # ---- 4b. main path of this slice: calibrate → drizzle → stretch ----
    t0 = time.perf_counter()
    bias, darks, flats, lights, dith = calibration_scene(
        DRZ_N, DRZ_HW, DRZ_SEED + 1, dev)
    torch.cuda.synchronize()
    log(f"[data] calibration scene: {bias.shape[0]} bias, {darks.shape[0]} "
        f"darks, {flats.shape[0]} flats, {lights.shape[0]} lights of "
        f"{DRZ_HW}^2, dithers in +-2 px (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    for fn in counters.values():
        fn.launches = 0
    calibrated = calibrate(bias, darks, flats, lights)
    dres = drizzle_stack(calibrated, DrizzleConfig())
    dstf, dprev = stf_preview(dres.image)
    torch.cuda.synchronize()
    launches_drizzle = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in calibrate → drizzle_stack → stretch: "
        f"{launches_drizzle}")
    for name in ("coarse_box", "gather_crops", "drizzle_finalize_fused"):
        if launches_drizzle[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_drizzle}")

    if dres.output_dims != (out_hw, out_hw) or \
            dres.image.shape != (out_hw, out_hw):
        raise AssertionError(f"drizzle output {dres.output_dims}")
    if not bool(torch.isfinite(dres.image).all()) or \
            not bool(torch.isfinite(dres.weight_map).all()):
        raise AssertionError("drizzle image or weights not finite")
    if dprev.dtype != torch.uint8 or dprev.shape != (out_hw, out_hw):
        raise AssertionError("drizzle preview is not u8")
    doff = np.asarray(dres.offsets)[:, ::-1]   # (dx, dy) → (dy, dx)
    doff_err = float(np.abs(doff - dith).max())
    log(f"[path] drizzle_stack offsets vs generator dithers: max|d|="
        f"{doff_err:.4f} px; rejected {dres.rejected_pixels}; stf "
        f"{dstf.tolist()}; weight map mean "
        f"{float(dres.weight_map.mean()):.4f}")
    if doff_err > 0.15:
        raise AssertionError(f"drizzle offsets off by {doff_err} px: "
                             f"{doff.tolist()} vs {dith.tolist()}")

    dres_p = drizzle_stack(calibrated, DrizzleConfig(), plain=True)
    dstf_p, _ = stf_preview(dres_p.image)
    torch.cuda.synchronize()
    d_off = float(np.abs(np.asarray(dres.offsets)
                         - np.asarray(dres_p.offsets)).max())
    d_stf = float((dstf - dstf_p).abs().max())
    d_img = float((dres.image - dres_p.image).abs().max())
    log(f"[path] drizzle kernel vs plain: offsets max|d|={d_off:.2e}, stf "
        f"max|d|={d_stf:.2e}, image max|d|={d_img:.3e}, rejected "
        f"{dres.rejected_pixels} vs {dres_p.rejected_pixels}")
    if d_off > 0.05 or d_stf > 1e-4:
        raise AssertionError("drizzle kernel path and plain path disagree")
    if not (torch.equal(dres.image, dres_p.image)
            and torch.equal(dres.weight_map, dres_p.weight_map)
            and dres.rejected_pixels == dres_p.rejected_pixels):
        raise AssertionError("drizzle image, weights or rejected count "
                             "not bit-equal to the plain path")
    del dres_p

    d_ys_t = torch.tensor([-o[1] for o in dres.offsets], device=dev)
    d_xs_t = torch.tensor([-o[0] for o in dres.offsets], device=dev)
    cal_stack = torch.stack(calibrated)
    exact_args = (cal_stack, d_ys_t, d_xs_t, 2.0, 0.7, DrizzleKernel.SQUARE,
                  out_hw, out_hw, 3.0, 3.0, 5)
    torch.cuda.reset_peak_memory_stats()
    ms_d = cuda_ms(lambda: drizzle_stack(calibrated, DrizzleConfig()), 2)
    peak_d = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_dp = cuda_ms(lambda: drizzle_stack(calibrated, DrizzleConfig(),
                                          plain=True), 1)
    peak_dp = torch.cuda.max_memory_allocated()
    ms_full = cuda_ms(lambda: stf_preview(drizzle_stack(
        calibrate(bias, darks, flats, lights), DrizzleConfig()).image), 1)
    torch.cuda.reset_peak_memory_stats()
    ms_b = cuda_ms(lambda: _drizzle_kernel_exact(
        *exact_args, band_rows=DRZ_BAND), 2)
    peak_b = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_bp = cuda_ms(lambda: _drizzle_kernel_exact(
        *exact_args, band_rows=DRZ_BAND, plain=True), 1)
    peak_bp = torch.cuda.max_memory_allocated()
    log(f"[time] {smi}: drizzle_stack {DRZ_N}x{DRZ_HW}^2 -> {out_hw}^2 "
        f"(band 64, offsets fetch included) kernels {ms_d:.3f} ms (peak "
        f"{peak_d / 2**30:.2f} GiB) | plain {ms_dp:.3f} ms (peak "
        f"{peak_dp / 2**30:.2f} GiB)")
    log(f"[time] {smi}: _drizzle_kernel_exact band {DRZ_BAND} kernels "
        f"{ms_b:.3f} ms (peak {peak_b / 2**30:.2f} GiB) | plain "
        f"{ms_bp:.3f} ms (peak {peak_bp / 2**30:.2f} GiB)")
    log(f"[time] {smi}: calibrate (16+16+16 masters, {DRZ_N} lights) → "
        f"drizzle_stack → stats/STF/u8: {ms_full:.3f} ms")
    if "jax" in sys.modules or "astroburst_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")

    # ---- 5. report -----------------------------------------------------
    meta = {
        "shift_clip": ("astroburst_tpu_torch/csrc/shift_clip.cu",
                       "astroburst_tpu/stacking/onepass_kernel.py:262"),
        "coarse_box": ("astroburst_tpu_torch/csrc/coarse_box.cu",
                       "astroburst_tpu/alignment/coarse_kernel.py:155"),
        "gather_crops": ("astroburst_tpu_torch/csrc/gather_crops.cu",
                         "astroburst_tpu/ops/crop_kernel.py:50"),
        "drizzle_finalize_fused": (
            "astroburst_tpu_torch/csrc/drizzle_finalize.cu",
            "astroburst_tpu/stacking/drizzle_kernel.py:292"),
        "drizzle_finalize": (
            "astroburst_tpu_torch/csrc/drizzle_finalize.cu",
            "astroburst_tpu/stacking/drizzle_kernel.py:339"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": launches_stack[name] + launches_drizzle[name],
                 "launches_by_path": {
                     "align_stack_stretch+stack_images":
                         launches_stack[name],
                     "calibrate+drizzle_stack": launches_drizzle[name]}}
        entry.update(report[name])
        kernels.append(entry)
    kernels[0]["also_replaces"] = [
        "astroburst_tpu/stacking/fused_kernel.py:223",
        "astroburst_tpu/stacking/rolling_kernel.py:226",
        "astroburst_tpu/stacking/clip_kernel.py:183"]
    kernels[-1]["on_main_path"] = False   # K8: the JAX tests' entry only
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
