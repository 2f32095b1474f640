#!/usr/bin/env python3
"""Readings for setting a cell's limits: runs of the cell on several
seeds in one process (one set-up of torch and the card), each printed
as a JSON line with its compared numbers, and with ``--control`` the
control's readings too (the plain reference computed in bfloat16 in
the program's place, against the reference in float32).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds 4 [--control]

The benchmark's runs never run this; limits are set from its output
(see PERF.md).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.core.env import prepare
    prepare(ROOT)
    import json
    import torch
    from benchmark.core.harness import run_cell
    from benchmark.core.spec import Spec
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(spec, args.workload, seed, args.seconds, False,
                     torch.device("cuda", 0), time.perf_counter(),
                     control=args.control)
        if r is None:
            return 3
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "program": {k: v["value"]
                                      for k, v in r["checks"].items()},
                          "control": r.get("control_checks"),
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
