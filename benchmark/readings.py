#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, at a cell's own
size, in one process (set-up is long):

    python3 benchmark/readings.py --workload svc5-live --seeds 1 2 3 \
        --control-seeds 4 5 6 --seconds 4 --out readings.json

For each seed of --seeds the program's numbers (a short window at the cell's
own load, then the comparison a run makes); for each of --control-seeds the
same numbers with the control, the reference in TF32, put in the program's
place; for a training cell also --fault-seeds, the reference on half of each
batch's rows in the program's place. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def read(name, seed, seconds, mode, device, root=None):
    import torch

    from benchmark.harness import ROOT, driver_class, load_cell

    cell = load_cell(name, root or ROOT)
    drv = driver_class(cell)(cell, seed, device)
    t = time.perf_counter()
    drv.setup()
    t0 = time.perf_counter()
    records = []
    while time.perf_counter() - t0 < seconds:
        records.append(drv.unit())
    drv.release()
    row = dict(seed=seed, mode=mode, units=len(records), seconds=time.perf_counter() - t)
    row["checks"] = {n: v for n, v, _ in drv.check(records, mode)}
    if hasattr(drv, "readings"):
        row["leaves"] = drv.readings(mode)
    del drv
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    plan = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, "half_batch") for s in args.fault_seeds])
    for seed, mode in plan:
        row = read(args.workload, seed, args.seconds, mode, "cuda")
        print(json.dumps(row), flush=True)
        rows.append(row)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(workload=args.workload, card=torch.cuda.get_device_name(0),
                                                  rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
