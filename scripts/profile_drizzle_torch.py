#!/usr/bin/env python3
"""Where the time of the port's drizzle goes, on one CUDA card.

    python3 scripts/profile_drizzle_torch.py [--runs 2]

Builds chip_smoke.py's calibration scene (16 bias, 16 dark, 16 flat
frames, 10 lights of 4096^2 with sub-pixel dithers), calibrates the
lights, then profiles with torch.profiler, after two warm-up calls:

- ``drizzle_stack`` with the default config (scale 2, pixfrac 0.7,
  square, 5 iterations: the exact route, 64-row bands), alignment
  included;
- ``_drizzle_kernel_exact`` at 1024-row bands on the same frames and
  offsets (the JAX package's drizzle bench setting).

For each it prints the host time per call, the device time per call by
kernel name (top 12), the number of device kernels per call, the device
busy time and the idle share of the profiled span, and one JSON line
of the same numbers; the card's name and power limit come first.
Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def busy_us(intervals):
    """Length of the union of (start, end) intervals, in µs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(name, fn, runs):
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / runs
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_us(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[{name}] host {host_ms:.3f} ms per call (profiler on); device "
          f"busy {busy / 1e3 / runs:.3f} ms per call of a "
          f"{span / 1e3 / runs:.3f} ms span, idle share "
          f"{1 - busy / span:.3f}; {len(kernels) / runs:.0f} kernels per "
          f"call", flush=True)
    for kname, (t, c) in top:
        print(f"  {t / 1e3 / runs:9.3f} ms  {c / runs:6.0f}x  {kname[:110]}",
              flush=True)
    return {"name": name, "host_ms": host_ms,
            "device_busy_ms": busy / 1e3 / runs,
            "device_span_ms": span / 1e3 / runs,
            "idle_share": 1 - busy / span,
            "kernels_per_call": len(kernels) / runs,
            "top": [{"kernel": k[:110], "ms": t / 1e3 / runs,
                     "launches": c / runs} for k, (t, c) in top]}


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_drizzle_torch: no CUDA device")

    import chip_smoke as cs
    from astroburst_tpu_torch.dtypes import DrizzleConfig, DrizzleKernel
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.drizzle import (_drizzle_kernel_exact,
                                                       drizzle_stack)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = cuda_device()
    bias, darks, flats, lights, _ = cs.calibration_scene(
        cs.DRZ_N, cs.DRZ_HW, cs.DRZ_SEED + 1, dev)
    cal = cs.calibrate(bias, darks, flats, lights)
    res = drizzle_stack(cal, DrizzleConfig())
    d_ys = torch.tensor([-o[1] for o in res.offsets], device=dev)
    d_xs = torch.tensor([-o[0] for o in res.offsets], device=dev)
    stack = torch.stack(cal)
    out = 2 * cs.DRZ_HW
    rows = [
        profile("drizzle_stack band 64",
                lambda: drizzle_stack(cal, DrizzleConfig()), args.runs),
        profile(f"_drizzle_kernel_exact band {cs.DRZ_BAND}",
                lambda: _drizzle_kernel_exact(
                    stack, d_ys, d_xs, 2.0, 0.7, DrizzleKernel.SQUARE, out,
                    out, 3.0, 3.0, 5, band_rows=cs.DRZ_BAND), args.runs)]
    print(json.dumps({"device": smi, "profiles": rows}), flush=True)


if __name__ == "__main__":
    main()
