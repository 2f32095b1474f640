#!/usr/bin/env python3
"""Where the time of the port's masked stretch and parity drizzle goes,
on one CUDA card.

    python3 scripts/profile_masked_torch.py [--runs 3]

Builds chip_smoke.py's scenes on the card — the 4096^2 field of 3000
stars scaled into [0, 1) (``MS_SCALE``) and the drizzle bench stack
(10 x 4096^2 normal(100, 8), offsets in +-2 px) — and profiles with
torch.profiler, after two warm-up calls:

- ``masked_stretch`` fixed x10 (convergence_threshold 0) and at the
  default threshold;
- ``masked_stretch_rgb_shared`` on three channels made from the field;
- ``drizzle_exact_parity`` (scale 2, pixfrac 0.7, square, 5 iterations).

For each it prints what scripts/profile_drizzle_torch.py prints: host
time per call, device time by kernel name (top 12), kernels per call,
device busy time and the idle share of the span. One JSON line holds
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


def main():
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_masked_torch: no CUDA device")

    import chip_smoke as cs
    from profile_drizzle_torch import profile
    from astroburst_tpu_torch.dtypes import DrizzleKernel
    from astroburst_tpu_torch.imaging.masked_stretch import (
        MaskedStretchConfig, masked_stretch, masked_stretch_rgb_shared)
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.drizzle import drizzle_exact_parity
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = cuda_device()
    field = cs.star_scene(cs.DET_HW, cs.DET_HW, cs.DET_STARS, 21,
                          dev)[0] / cs.MS_SCALE
    g = torch.Generator(device=dev).manual_seed(27)
    rgb = (field, 0.8 * field + 5e-4 * torch.randn(
        field.shape, generator=g, device=dev), 1.2 * field - 4e-3)
    fixed = MaskedStretchConfig(convergence_threshold=0.0)
    conv = MaskedStretchConfig()
    drng = np.random.default_rng(cs.DRZ_SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.DRZ_SEED)
    dstack = torch.randn((cs.DRZ_N, cs.DRZ_HW, cs.DRZ_HW), generator=gen,
                         device=dev) * 8.0 + 100.0
    d_ys, d_xs = (torch.as_tensor(drng.uniform(-2, 2, cs.DRZ_N),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
    out_hw = 2 * cs.DRZ_HW
    rows = [
        profile(f"masked_stretch x10 {cs.DET_HW}^2",
                lambda: masked_stretch(field, fixed), args.runs),
        profile(f"masked_stretch converged {cs.DET_HW}^2",
                lambda: masked_stretch(field, conv), args.runs),
        profile(f"masked_stretch_rgb_shared 3 x {cs.DET_HW}^2",
                lambda: masked_stretch_rgb_shared(*rgb, conv), args.runs),
        profile(f"drizzle_exact_parity {cs.DRZ_N}x{cs.DRZ_HW}^2 -> "
                f"{out_hw}^2", lambda: drizzle_exact_parity(
                    dstack, d_ys, d_xs, 2.0, 0.7, DrizzleKernel.SQUARE,
                    out_hw, out_hw, 3.0, 3.0, 5), args.runs)]
    print(json.dumps({"device": smi, "profiles": rows}), flush=True)


if __name__ == "__main__":
    main()
