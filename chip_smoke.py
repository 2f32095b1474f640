#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (astroburst_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (nothing is caught; any failure
exits non-zero, and so does a machine without a CUDA device):

1. device: card name and count, torch/CUDA/nvcc versions, the card's
   name and power limit from nvidia-smi; TF32 must be off;
2. build: nvcc builds every kernel of ``astroburst_tpu_torch/csrc`` for
   sm_90a; registers, shared memory and spills of each kernel and the
   build seconds are printed;
3. kernels: each CUDA kernel against its plain torch version on the
   card, at the shapes of the main path (the bench workload: 16 frames
   of 5655 x 2206 f32), K3 also at 24 x 2048^2 with offsets up to
   +-200 and at 1, 48 and 100 frames with NaN/inf pixels (every
   template instance of the kernel), K1 also on NaN/inf frames;
4. main path: ``align_stack_stretch`` on the bench workload and
   ``stack_images`` on 24 frames of 2048^2 (shifts up to +-200),
   with every kernel launch counter reset just before and read just
   after; offsets must match the generator's shifts; then both entry
   points again through the plain versions on the card, compared with
   the kernel path, and both paths timed with CUDA events;
5. report: one JSON line of per-kernel results, the card's name and
   power limit, and the final ``{"ok": true, "device": ...}`` line.

Tolerances. K1 box means: rtol 1e-5 (f32 sums in another order);
K1 min/max/count and K2 crops: exact. K3 and the combined planes: at
most max(3, 1e-5 * frames * pixels) pixels differ by more than 5e-3,
and the rejected counts by at most as many — borderline clip decisions
flip on the last ulp when the tap sums contract to FMA in another
order, and each of a pixel's values can be the one that flips. (The
JAX package's own bound, tests/test_onepass_kernel.py:36-40, is 3
pixels of 6 x 130 x 170 pixel-frames, 2.3e-5; here it is 1e-5 of the
pixel-frames.) Offsets: within
0.1 px of the generator's integer shifts and within 0.05 px between
the kernel and plain paths. STF parameters: within 1e-4.
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
FLIP_ATOL = 5e-3


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
        tmpl = re.search(r"ILi(\d+)E", sym)
        if tmpl:
            name += f"<{tmpl.group(1)}>"
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", b)
        regs = re.search(r"Used (\d+) registers", b)
        smem = re.search(r"(\d+) bytes smem", b)
        rows.append((name, int(regs.group(1)),
                     int(smem.group(1)) if smem else 0,
                     int(stack.group(1)), int(stack.group(2)),
                     int(stack.group(3))))
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")

    import bench
    from astroburst_tpu_torch.alignment.coarse_kernel import (
        coarse_downsample_stack, coarse_downsample_stack_plain)
    from astroburst_tpu_torch.alignment.phase_correlation import (
        REFINE_CROP_SIZE, _refine_origin)
    from astroburst_tpu_torch.convert import stack_from_numpy
    from astroburst_tpu_torch.ops.crop_kernel import (gather_crops,
                                                      gather_crops_plain)
    from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import (cuda_device,
                                                     tf32_disabled)
    from astroburst_tpu_torch.stacking.combine import stack_images
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        shift_clip_onepass, shift_clip_onepass_plain)

    # ---- 1. device ---------------------------------------------------
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
        f"nvcc {lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f}"
        f" s)")
    rows = ptxas_summary(lib.build_log)
    for name, regs, smem, stack, sst, sld in rows:
        log(f"[build]   {name}: sm_90a, {regs} registers, {smem} B smem, "
            f"{stack} B stack, spills {sst}/{sld} B")
    built = {r[0].split("<")[0] for r in rows}
    want = {"shift_clip_kernel", "coarse_box_kernel", "gather_crops_kernel"}
    if not want <= built:
        raise AssertionError(f"kernels missing from the build: "
                             f"{want - built}")

    # ---- 3. kernels vs plain at the main path's shapes ---------------
    t0 = time.perf_counter()
    frames = bench.make_frames(N_FRAMES, H, W)
    shifts = bench_shifts(N_FRAMES, H, W)
    for k in (1, N_FRAMES - 1):  # the replayed shifts are bench's own
        resid = frames[k] - np.roll(frames[0], tuple(shifts[k]), (0, 1))
        if float(resid[64:-64, 64:-64].std()) > 4.0:
            raise AssertionError("bench_shifts no longer replays "
                                 "bench.make_frames")
    stack = stack_from_numpy(frames, dev)
    del frames
    big_frames, big_shifts = wide_shift_frames(BIG_N, BIG_HW, BIG_SHIFT)
    log(f"[data] bench stack {tuple(stack.shape)}, {BIG_N} frames of "
        f"{BIG_HW}^2 (made in {time.perf_counter() - t0:.1f} s)")
    report = {}

    a = coarse_downsample_stack(stack, 512, with_stats=True)
    b = coarse_downsample_stack_plain(stack, 512, with_stats=True)
    torch.cuda.synchronize()
    by, bx = -(-H // 512), -(-W // 512)   # 12, 5 at the bench shape
    if a[0].shape != (N_FRAMES, H // by, W // bx) or a[1:3] != (by, bx):
        raise AssertionError(f"K1 plan {a[0].shape} {a[1:3]}")
    if not torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-6):
        raise AssertionError("K1 box means differ from the plain version")
    for x, y, what in zip(a[3:], b[3:], ("min", "max", "count")):
        if not torch.equal(x, y):
            raise AssertionError(f"K1 {what} differs")
    k1_err = float((a[0] - b[0]).abs().max())
    log(f"[K1] coarse_box {list(stack.shape)} -> {tuple(a[0].shape)}: "
        f"max|d|={k1_err:.3e}; min/max/count exact")
    report["coarse_box"] = {"max_abs_err": k1_err, "ms": cuda_ms(
        lambda: coarse_downsample_stack(stack, 512, with_stats=True), 20),
        "plain_ms": cuda_ms(lambda: coarse_downsample_stack_plain(
            stack, 512, with_stats=True), 5)}

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
    report["gather_crops"] = {"max_abs_err": 0.0, "ms": cuda_ms(
        lambda: gather_crops(stack, y0s, x0s, 512, 512, frame0=1), 50),
        "plain_ms": cuda_ms(lambda: gather_crops_plain(
            stack, y0s, x0s, 512, 512, frame0=1), 20)}

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
    report["shift_clip"] = {"max_abs_err": k3_err, "flips": k3_flips,
                            "ms": cuda_ms(lambda: shift_clip_onepass(
                                stack, dys, dxs), 10),
                            "plain_ms": cuda_ms(
                                lambda: shift_clip_onepass_plain(
                                    stack, dys, dxs), 3)}
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
            big, bdys, bdxs), 3)})
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

    # ---- 4. the main path, through the kernels -------------------------
    counters = {"shift_clip": shift_clip_onepass,
                "coarse_box": coarse_downsample_stack,
                "gather_crops": gather_crops}
    big_list = [torch.as_tensor(f, device=dev) for f in big_frames]
    del big_frames
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = align_stack_stretch(stack)
    res = stack_images(big_list)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in align_stack_stretch + stack_images: "
        f"{launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

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

    mpx = N_FRAMES * H * W / 1e6
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
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # ---- 5. report -----------------------------------------------------
    meta = {
        "shift_clip": ("astroburst_tpu_torch/csrc/shift_clip.cu",
                       "astroburst_tpu/stacking/onepass_kernel.py:262"),
        "coarse_box": ("astroburst_tpu_torch/csrc/coarse_box.cu",
                       "astroburst_tpu/alignment/coarse_kernel.py:155"),
        "gather_crops": ("astroburst_tpu_torch/csrc/gather_crops.cu",
                         "astroburst_tpu/ops/crop_kernel.py:50"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name]}
        entry.update(report[name])
        kernels.append(entry)
    kernels[0]["also_replaces"] = "astroburst_tpu/stacking/fused_kernel.py:223"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
