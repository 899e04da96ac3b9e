#!/usr/bin/env python3
"""Registers, spills and SASS instruction counts of the package's kernels.

    python3 sass_counts.py [--json out/sass_counts.json] [--dump DIR]

Compiles csrc/snake_alias.cu, snake_alias_bwd.cu, snake_alias_mma.cu and
amp_iter.cu with the package's nvcc flags plus `-Xptxas -v`, and, where
build/prev_kernels/ holds an earlier version's snake_alias_mma.cu and
amp_iter.cu with their snake_alias.cuh (kept out of git), those too; prints
ptxas's registers, spills and stack frame of every kernel, then counts the
SASS instructions of each kernel (`cuobjdump -sass`) by opcode: shared
loads and stores (LDS, STS), shuffles (SHFL), f32 arithmetic (FFMA, FMUL,
FADD), the special-function unit (MUFU), tensor-core products (HMMA),
global and local memory (LDG, STG, LDL, STL), asynchronous copies (LDGSTS,
UTMALDG) and the total. The counts are static: every instruction of the
kernel once, cold paths included (element by element loads at row edges,
sinf's reduction for |x| > ~1e5). Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda

ROOT = Path(__file__).resolve().parent
PREV_DIR = ROOT / "build" / "prev_kernels"
CLASSES = ("LDS", "STS", "SHFL", "FFMA", "FMUL", "FADD", "MUFU", "HMMA", "LDG", "STG", "LDL",
           "STL", "LDGSTS", "UTMALDG")


def compile_and_count(source: Path, label: str, dump: Path | None = None) -> list[dict]:
    """ptxas's lines and the per-kernel opcode counts of one source; with
    `dump`, the whole SASS is written there as <label>_<source stem>.sass."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "lib.so"
        cmd = [snake_cuda._nvcc(), *snake_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
               str(source)]
        ptxas = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        cuobjdump = Path(snake_cuda._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    if dump:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"{label}_{source.stem}.sass").write_text(sass)
    usage = {}
    name = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage.setdefault(name, {})["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            usage.setdefault(name, {})["stack_bytes"] = int(m.group(1))
    rows, counts, name = [], None, None
    for line in sass.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                rows.append(dict(source=label, kernel=name,
                                 dtype="bf16" if "bfloat16" in name else "f32",
                                 **usage.get(name, {}), total=sum(counts.values()),
                                 **{k: counts.get(k, 0) for k in CLASSES}))
            name, counts = m.group(1), Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and name is not None:
            counts[m.group(1)] += 1
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the rows here")
    ap.add_argument("--dump", type=Path, default=None, help="write each source's SASS here")
    args = ap.parse_args()
    sources = [(src, "new") for src in (snake_cuda.SOURCE, snake_cuda.SOURCE_BWD,
                                         snake_cuda.SOURCE_MMA, amp_cuda.SOURCE)]
    prev = ("snake_alias_mma.cu", "amp_iter.cu")
    if all((PREV_DIR / n).exists() for n in (*prev, "snake_alias.cuh")):
        sources += [(PREV_DIR / n, "prev") for n in prev]
    rows = []
    for source, label in sources:
        rows += compile_and_count(source, label, args.dump)
    for r in rows:
        print("[sass] " + json.dumps(r), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
