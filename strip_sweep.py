#!/usr/bin/env python3
"""How the strips snake kernel's time depends on its segment length, on one
NVIDIA GPU.

    python3 strip_sweep.py

For the five generator stage shapes of a 1020-frame chunk at base width and
the narrowest training shape, times the direct kernel (one block per
1024-sample tile) and the strips kernel with each row cut into segments of
128 ... 4096 samples (a block walks its segment tile after tile), by CUDA
events over inputs rotated through more than 100 MB, and holds every strips
result bitwise equal to the direct kernel's. It is where
ops/snake_cuda.py::strip_fold's limits (no segment under 256 or over 2048
samples) come from. Prints one JSON line per shape, times in microseconds,
then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from chip_smoke import cuda_ms, snake_inputs
from whisper_vits_svc_tpu_torch.ops import snake_cuda

SHAPES = ((1, 160, 5100), (1, 80, 20400), (1, 40, 81600), (1, 20, 163200), (1, 10, 326400),
          (16, 10, 8000))
SEGMENTS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def main() -> int:
    if not torch.cuda.is_available():
        print("strip_sweep: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    for shape in SHAPES:
        xs, alpha, beta = snake_inputs(shape, torch.float32, seed=1)
        b, c, t = shape
        want = snake_cuda.snake_alias_cuda(xs[0], alpha, beta)
        row = {"shape": list(shape), "default_fold": snake_cuda.strip_fold(c, t, b)}
        row["direct_us"] = 1e3 * cuda_ms(
            lambda i=0: snake_cuda.snake_alias_cuda(xs[i % len(xs)], alpha, beta), 20)
        row["strips_us"] = 1e3 * cuda_ms(
            lambda i=0: snake_cuda.snake_alias_strips_cuda(xs[i % len(xs)], alpha, beta), 20)
        for seg in SEGMENTS:
            if seg > t:
                continue
            fold = -(-t // seg)
            got = snake_cuda.snake_alias_strips_cuda(xs[0], alpha, beta, fold=fold)
            if not torch.equal(got, want):
                raise SystemExit(f"strip_sweep: FAILED: fold {fold} at {shape} is not bitwise "
                                 f"equal to the direct kernel")
            row[f"seg_{seg}_us"] = 1e3 * cuda_ms(
                lambda i=0: snake_cuda.snake_alias_strips_cuda(
                    xs[i % len(xs)], alpha, beta, fold=fold), 20)
        print(json.dumps({k: round(v, 2) if isinstance(v, float) else v
                          for k, v in row.items()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
