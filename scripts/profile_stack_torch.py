#!/usr/bin/env python3
"""Where the time of the port's align → stack → stretch path goes, on one
CUDA card.

    python3 scripts/profile_stack_torch.py [--runs 3]

Profiles with torch.profiler, after two warm-up calls (the profile and
its printout are profile_drizzle_torch.py's):

- ``align_stack_stretch`` on chip_smoke.py's bench workload (16 x 5655 x
  2206 f32, K3's register instance);
- ``stack_images`` on 24 frames of 2048^2 with shifts up to +-200;
- ``stack_images`` on 150 frames of 1024^2 with shifts up to +-100 (K3's
  scratch instance, past 128 frames).

For each it prints the host time per call, the device time per call by
kernel name (top 12), the kernels per call, the device busy time and
the idle share of the profiled span, and one JSON line of the same
numbers; the card's name and power limit come first. Imports torch and
the port only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from profile_drizzle_torch import profile  # noqa: E402  (same directory)


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_stack_torch: no CUDA device")

    import chip_smoke as cs
    from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.combine import stack_images
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = cuda_device()
    stack = torch.as_tensor(cs.make_frames(cs.N_FRAMES, cs.H, cs.W),
                            device=dev)
    big, _ = cs.wide_shift_frames(cs.BIG_N, cs.BIG_HW, cs.BIG_SHIFT)
    big = [torch.as_tensor(f, device=dev) for f in big]
    many, _ = cs.wide_shift_frames(cs.MANY_N, cs.MANY_HW, cs.MANY_SHIFT,
                                   seed=12)
    many = [torch.as_tensor(f, device=dev) for f in many]
    rows = [
        profile(f"align_stack_stretch {cs.N_FRAMES}x{cs.H}x{cs.W}",
                lambda: align_stack_stretch(stack), args.runs),
        profile(f"stack_images {cs.BIG_N}x{cs.BIG_HW}^2",
                lambda: stack_images(big), args.runs),
        profile(f"stack_images {cs.MANY_N}x{cs.MANY_HW}^2",
                lambda: stack_images(many), args.runs)]
    print(json.dumps({"device": smi, "profiles": rows}), flush=True)


if __name__ == "__main__":
    main()
