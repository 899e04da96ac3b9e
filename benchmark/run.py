#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload svc5-live --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with the cell's cards. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 the breakdown, and last the
numbers compared against the reference beside their limits, which are also
the last lines of standard error. Exits non-zero without a result when
CUDA is missing or has fewer cards than the cell asks for, when the program
is missing, or when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
BUILD = CHECKOUT / "build"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark.guard import loaded_forbidden
    from benchmark.harness import load_json, run_cell, schema_errors

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START)
    bad = loaded_forbidden(sys.modules)
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    errs = schema_errors(result)
    if errs:
        print(f"benchmark: malformed result: {errs}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
