"""One run of one cell: find the cell's files by name, set up its driver,
measure a window, read the per-layer metrics from a profiled slice, check
the outputs against the reference, and build the result line.

A cell is `workloads/<name>.json`: its configuration (`configs/<config>.json`),
its driver (`drivers/<driver>.py`) and the driver's traffic parameters. A
per-layer metric `<quantity>.<suffix>` is read by `metrics/<name>.py` or, if
there is none, `metrics/<quantity>.py`. BENCHMARK.json says which per-layer
metrics a cell reports. Adding a cell of an existing driver is one new file
under workloads/.

A driver module defines `Driver(cell, seed, device)` with:
  setup()            build the program's object, traffic and warm-up
  unit() -> dict     one request, push or step of the window (t0, t1 inside)
  end_to_end(records, t0) -> {metric: value}
  work(records) -> dict   the window's units' FLOPs (the trace run)
  slice_work(records) -> dict   the snake calls of the profiled slice's units
  release()          drop the program's state on the device
  check(records) -> [(name, value, limit)]   the comparison with the reference
  spans() -> {name: module}  host ranges around modules' forwards in the slice
and the attributes `unit_span` (the host range around a unit) and
`trace_units` (units in the profiled slice).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import torch

from .trace.chrome import Trace, load_events

ROOT = Path(__file__).resolve().parent
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    wl = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{wl['config']}.json")
    return SimpleNamespace(name=name, workload=wl, config=cfg, model=cfg["model"], root=root,
                           params=wl["traffic"], limits=wl["limits"], mark=lambda what: None)


def peaks_for(device_name: str, root: Path = ROOT) -> dict:
    for key, peaks in load_json(root / "peaks.json").items():
        if not key.startswith("_") and key in device_name:
            return peaks
    return {}


def per_layer_names(cell_name: str, bench: dict) -> list[str]:
    return [m["name"] for m in bench.get("per_layer", []) if cell_name in m.get("workloads", [])]


def reader(root: Path, metric: str):
    for stem in (metric, metric.split(".", 1)[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} under {root / 'metrics'}")


def driver_class(cell):
    name = cell.workload["driver"]
    path = cell.root / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.drivers.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Driver


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def module_spans(spans: dict):
    """A host range named `name` around every forward of each module in
    {name: module}, from the benchmark's side (forward hooks), while inside."""
    handles, open_ranges = [], []

    def enter(name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for name, module in spans.items():
        handles += [module.register_forward_pre_hook(enter(name)),
                    module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def profile_slice(drv, device) -> tuple[list[dict], Trace | None]:
    """Run drv.trace_units units under torch.profiler inside the host range
    "bench.slice", with the driver's module spans; returns their records
    and the parsed trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        with torch.profiler.profile(activities=acts) as prof, module_spans(drv.spans()):
            with torch.profiler.record_function("bench.slice"):
                recs = [drv.unit() for _ in range(drv.trace_units)]
                sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = load_events(path)
    trace = Trace(events, "bench.slice")
    return recs, (trace if trace.device else None)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Path = ROOT, t_start: float | None = None, log=sys.stderr) -> dict:
    """One run; returns the result dict (its `checks` last). t_start is when
    the process started, for setup_s."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    cell.mark = lambda what: print(f"setup {what} at {time.perf_counter() - t_start:.3f} s",
                                   file=log)
    cell.mark("imports")
    bench_file = root.parent / "BENCHMARK.json"
    bench = load_json(bench_file) if bench_file.exists() else {}
    drv = driver_class(cell)(cell, seed, device)
    torch.zeros(1, device=device)
    cell.mark("device context")
    drv.setup()
    sync(device)
    cell.mark("warm-up")
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    records = []
    while time.perf_counter() - t0 < seconds:
        records.append(drv.unit())
    metrics = {}
    breakdown = None
    dev_info = {}
    is_cuda = torch.device(device).type == "cuda"
    if not trace:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in drv.end_to_end(records, t0).items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        work = drv.work(records)
        work["wall_s"] = records[-1]["t1"] - t0
        traced, tr = profile_slice(drv, device)
        work.update(drv.slice_work(traced))
        peaks = peaks_for(torch.cuda.get_device_name(0) if is_cuda else "", root)
        ctx = SimpleNamespace(trace=tr, work=work, peaks=peaks, cell=cell)
        for m in per_layer_names(name, bench):
            value = reader(root, m)(ctx)
            if value is not None:
                unit = next((e["unit"] for e in bench["per_layer"] if e["name"] == m), "%")
                metrics[m] = {"value": value, "unit": unit}
        records = records + traced
        if tr is not None:
            dev_info = dict(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    device_block = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if is_cuda else 0,
    } | dev_info
    drv.release()
    checks = drv.check(records)
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": len(records), "failed": 0,
              "metrics": metrics, "device": device_block}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=log)
    return result


def schema_errors(result: dict) -> list[str]:
    """What is wrong with a result line, by the benchmark's contract."""
    errs = [f"missing {k}" for k in RESULT_KEYS if k not in result]
    if errs:
        return errs
    if not isinstance(result["correct"], bool):
        errs.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(result[k], int) or result[k] < 0:
            errs.append(f"{k} is not a count")
    for name, m in result["metrics"].items():
        if set(m) != {"value", "unit"} or not isinstance(m["value"], (int, float)):
            errs.append(f"metric {name} is not {{value, unit}}")
    dev = result["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in dev:
            errs.append(f"device lacks {k}")
    bd = result.get("breakdown")
    if bd is not None:
        for k in ("device_ops", "idle_gaps"):
            if len(bd.get(k, [])) > 10:
                errs.append(f"breakdown {k} has more than 10 entries")
    if list(result)[-1] != "checks":
        errs.append("checks is not the last key")
    return errs
