#!/usr/bin/env python3
"""Where the time of the port's star detection and affine alignment goes,
on one CUDA card.

    python3 scripts/profile_detect_torch.py [--runs 3]

Builds chip_smoke.py's scenes on the card — the 4096^2 field of 3000
stars and the 5655 x 2206 affine bench pair (90 stars, rotation 0.4 deg)
— and profiles with torch.profiler, after two warm-up calls:

- ``detect_stars`` on the 4096^2 field (σ 5, 1024 peaks);
- ``align_channel_affine`` + ``warp_image`` on the 5655 x 2206 pair.

For each it prints what scripts/profile_drizzle_torch.py prints: host
time per call, device time by kernel name (top 12), kernels per call,
device busy time and the idle share of the span. Then, with the
profiler off, the host clock per stage of the real affine chain (each
stage ends in a synchronize; a stage called twice is summed):
normalization, the paired detection, the triangle lists, the vote and
greedy match, RANSAC, any phase-correlation fallback, the warp, and the
whole align_channel_affine call. One JSON line holds
all of it; the card's name and power limit come first. Imports torch
and the port only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


STAGES = ("normalize_for_detection", "detect_stars_pair", "build_triangles",
          "match_triangles", "ransac_affine", "_fallback_phase_correlation")


def affine_stages(ref, tgt, reps):
    """Mean host ms per call of align_channel_affine + warp_image, and
    per stage inside it: the real function runs with each callee of
    STAGES (looked up in the affine module) wrapped in a synchronized
    clock, so fallbacks and sanity checks are timed as they run."""
    import time

    import torch
    from astroburst_tpu_torch.alignment import affine as A
    ms = {}

    def clocked(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    saved = {name: getattr(A, name) for name in STAGES}
    for name, fn in saved.items():
        setattr(A, name, clocked(name, fn))
    whole = clocked("align_channel_affine (whole)", A.align_channel_affine)
    warp = clocked("warp_image", A.warp_image)
    total = {}
    try:
        for i in range(reps + 1):   # the first pass warms up and is dropped
            ms.clear()
            warp(tgt, whole(ref, tgt).transform, *ref.shape)
            if i:
                for k, v in ms.items():
                    total[k] = total.get(k, 0.0) + v
    finally:
        for name, fn in saved.items():
            setattr(A, name, fn)
    return {k: v / reps for k, v in total.items()}


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_detect_torch: no CUDA device")

    import chip_smoke as cs
    from profile_drizzle_torch import profile
    from astroburst_tpu_torch.alignment.affine import (align_channel_affine,
                                                       warp_image)
    from astroburst_tpu_torch.analysis import detect_stars
    from astroburst_tpu_torch.runtime.device import cuda_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = cuda_device()
    field = cs.star_scene(cs.DET_HW, cs.DET_HW, cs.DET_STARS, 21, dev)[0]
    ref, tgt = cs.affine_scene(cs.H, cs.W, cs.AFF_STARS_5K, 8, dev)
    rows = [
        profile(f"detect_stars {cs.DET_HW}^2", lambda: detect_stars(field),
                args.runs),
        profile(f"align_channel_affine + warp_image {cs.H}x{cs.W}",
                lambda: warp_image(tgt, align_channel_affine(
                    ref, tgt).transform, cs.H, cs.W), args.runs)]
    stages = affine_stages(ref, tgt, args.runs)
    for name, v in stages.items():
        print(f"[affine stage] {v:9.3f} ms  {name}", flush=True)
    print(json.dumps({"device": smi, "profiles": rows,
                      "affine_stages_ms": stages}), flush=True)


if __name__ == "__main__":
    main()
