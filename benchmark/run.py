#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The cells are in ``BENCHMARK.json``. The
last line of standard output is the result (JSON); the numbers that
decide ``correct`` are the last lines of standard error. Exits non-zero
and prints no result without a CUDA card (or with fewer cards than the
cell asks for), without the port, or when JAX or the JAX package was
loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark.core.env import prepare
    prepare(ROOT)
    from benchmark.core.harness import log, run_cell
    from benchmark.core.spec import Spec
    spec = Spec(ROOT)
    chips = spec.cell(args.workload).chips
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import astroburst_tpu_torch  # noqa: F401  (the program measured)
    except ImportError as exc:
        log(f"the program is not in this checkout: {exc}")
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0)
    return emit(result)


def emit(result) -> int:
    """Print the result line, unless the run gave none or JAX or the JAX
    package was loaded after the window (by the reference or the
    comparison): then print nothing and return non-zero."""
    from benchmark.core.guard import loaded_forbidden
    from benchmark.core.harness import dumps, log
    if result is None:
        return 3
    found = loaded_forbidden()
    if found:
        log(f"loaded before the result was printed, not allowed: {found}")
        return 3
    print(dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
