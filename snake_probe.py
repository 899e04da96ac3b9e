#!/usr/bin/env python3
"""How the snake kernels' time moves with their sine and their run length
(card only).

    python3 snake_probe.py

Builds four copies of csrc/snake_alias.cu and csrc/snake_alias_bwd.cu under
build/snake_probe/, each with an edited copy of snake_alias.cuh: "sinf" (the
package's own: CUDA's sinf/sincosf), "poly" (a branch-free Cody-Waite
reduction th = k pi/2 + r and Taylor polynomials of sin r and cos r, about
2e-7 from sin for |th| <= 2^14), "fast" (the MUFU intrinsics
__sinf/__sincosf, far less accurate: a floor for any sine), "run16" (the
package's body with 16 outputs a lane instead of 8) and "occupancy" (the
package's kernels asking ptxas for 6 resident forward blocks and 4
backward blocks an SM through __launch_bounds__). Times each copy's
forward at the five stage shapes of a 1020-frame chunk and at the training
step's five, and its backward at the training step's, float32, CUDA events
over rotated inputs (cold L2), the copies in turns on the same inputs;
prints ms per call and per chunk / per step, and each copy's max abs
difference from the package's kernel. The package's wrappers
(ops/snake_cuda.py) drive each copy's library.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from whisper_vits_svc_tpu_torch.ops import snake_cuda

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "snake_probe"
SNAKE = "__device__ __forceinline__ float snake(float u, float a, float ib) {\n"
SINCOS = "__device__ __forceinline__ void sin_sq_sin2(float th, float& sq, float& s2) {\n"
POLY = """__device__ __forceinline__ void probe_poly(float th, float& sq, float& s2) {
  const float k = rintf(th * 0.636619747f);
  float r = fmaf(k, -1.57079637f, th);
  r = fmaf(k, 4.37113883e-08f, r);
  r = fmaf(k, 1.71512451e-15f, r);
  const bool odd = __float_as_int(k + 12582912.0f) & 1;
  const float z = r * r;
  float ps = fmaf(z, 2.75573188e-06f, -1.98412701e-04f);
  ps = fmaf(z, ps, 8.33333377e-03f);
  ps = fmaf(z, ps, -1.66666672e-01f);
  const float sr = fmaf(z * r, ps, r);
  float pc = fmaf(z, 2.48015876e-05f, -1.38888892e-03f);
  pc = fmaf(z, pc, 4.16666679e-02f);
  pc = fmaf(z, pc, -0.5f);
  const float cr = fmaf(z, pc, 1.0f);
  const float h = odd ? cr : sr;
  sq = h * h;
  const float sc = 2.0f * sr * cr;
  s2 = odd ? -sc : sc;
}

"""
# per variant: (snake body, sin_sq_sin2 body, outputs a lane, minimum resident
# blocks of the forward and the backward kernel); None keeps the package's
VARIANTS = {
    "sinf": (None, None, 8, None),
    "poly": ("  float sq, s2;\n  probe_poly(u * a, sq, s2);\n  return u + ib * sq;\n",
             "  probe_poly(th, sq, s2);\n", 8, None),
    "fast": ("  const float s = __sinf(u * a);\n  return u + ib * (s * s);\n",
             "  float s, c;\n  __sincosf(th, &s, &c);\n  sq = s * s;\n  s2 = 2.0f * s * c;\n", 8,
             None),
    "run16": (None, None, 16, None),
    "occupancy": (None, None, 8, (6, 4)),
}
# (shape, calls): one 1020-frame chunk at base width, and one training step
CHUNK = [((1, 160, 5100), 18), ((1, 80, 20400), 18), ((1, 40, 81600), 18),
         ((1, 20, 163200), 18), ((1, 10, 326400), 19)]
STEP = [((16, 160, 125), 18), ((16, 80, 500), 18), ((16, 40, 2000), 18),
        ((16, 20, 4000), 18), ((16, 10, 8000), 19)]
SPIN_CYCLES = 200_000_000


def replace_body(header: str, signature: str, body: str) -> str:
    start = header.index(signature) + len(signature)
    return header[:start] + body + header[header.index("\n}\n", start) + 1:]


def variant_sources(name: str) -> tuple[Path, Path]:
    """csrc's forward and backward sources beside an edited header."""
    snake, sincos, run, blocks = VARIANTS[name]
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f, n in zip(("snake_alias.cu", "snake_alias_bwd.cu"), blocks or (None, None)):
        text = (snake_cuda.CSRC / f).read_text()
        if n:
            text = text.replace("__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {n})")
        (d / f).write_text(text)
    header = (snake_cuda.CSRC / "snake_alias.cuh").read_text()
    if snake is not None:
        header = replace_body(header, SNAKE, snake)
        header = replace_body(header, SINCOS, sincos)
        header = header.replace(SNAKE, POLY + SNAKE, 1)
    header = header.replace("constexpr int kRun = 8;", f"constexpr int kRun = {run};")
    (d / "snake_alias.cuh").write_text(header)
    return d / "snake_alias.cu", d / "snake_alias_bwd.cu"


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("snake_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    names = tuple(VARIANTS)
    sources = {n: variant_sources(n) for n in names}
    snake_cuda.build(*(s for pair in sources.values() for s in pair))
    libs = {}
    for n, (fwd, bwd) in sources.items():
        libs[n] = (
            snake_cuda.load_library(fwd, "snake_alias_forward",
                                    [snake_cuda._PTR] * 4 + [snake_cuda._TAPS]
                                    + [snake_cuda._INT] * 6 + [snake_cuda._PTR],
                                    "snake_alias_error_string"),
            snake_cuda.load_library(bwd, "snake_alias_backward",
                                    [snake_cuda._PTR] * 10 + [snake_cuda._TAPS]
                                    + [snake_cuda._INT] * 6 + [snake_cuda._PTR],
                                    "snake_alias_backward_error_string"))

    orig_bwd, orig_seg = snake_cuda._library_bwd, snake_cuda.SEG_LEN

    def forward(n, x, alpha, beta):
        snake_cuda.SEG_LEN = 31 * VARIANTS[n][2]
        try:
            plan = snake_cuda.snake_plan(*x.shape, x.element_size())
            return snake_cuda._launch_forward("snake_alias", lambda: libs[n][0], x, alpha,
                                              beta, after_shape=(plan.n_seg, snake_cuda.SEG_LEN))
        finally:
            snake_cuda.SEG_LEN = orig_seg

    def backward(n, x, alpha, beta, dy):
        snake_cuda._library_bwd = lambda: libs[n][1]
        snake_cuda.SEG_LEN = 31 * VARIANTS[n][2]
        try:
            return snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
        finally:
            snake_cuda._library_bwd, snake_cuda.SEG_LEN = orig_bwd, orig_seg

    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for label, stages, which in (("chunk-fwd", CHUNK, "fwd"), ("step-fwd", STEP, "fwd"),
                                 ("step-bwd", STEP, "bwd")):
        total = dict.fromkeys(names, 0.0)
        for shape, calls in stages:
            b, c, t = shape
            alpha = torch.randn(c, device="cuda", generator=g) * 0.3
            beta = torch.randn(c, device="cuda", generator=g) * 0.3
            n_buf = min(64, max(1, -(-100_000_000 // (2 * b * c * t * 4))))
            xs = [torch.randn(shape, device="cuda", generator=g) * 1.5 for _ in range(n_buf)]
            dys = [torch.randn(shape, device="cuda", generator=g) for _ in range(n_buf)]
            if which == "fwd":
                fns = {n: (lambda i=0, n=n: forward(n, xs[i % n_buf], alpha, beta)) for n in names}
            else:
                fns = {n: (lambda i=0, n=n: backward(n, xs[i % n_buf], alpha, beta, dys[i % n_buf]))
                       for n in names}
            ref = fns["sinf"]()
            diff = {}
            for n in names:
                got = fns[n]()
                pairs = zip(ref, got) if which == "bwd" else [(ref, got)]
                diff[n] = max((a - b_).abs().max().item() for a, b_ in pairs)
            iters = 50 if b * c * t < 2_000_000 else 20
            order = list(names) + list(reversed(names))  # in turns, each twice
            times = dict.fromkeys(names, 0.0)
            for n in order:
                times[n] += cuda_ms(fns[n], iters) / 2
            for n in names:
                total[n] += calls * times[n]
            print(f"[snake-probe] {label} {list(shape)}: ms per call "
                  + json.dumps({n: round(v, 5) for n, v in times.items()})
                  + " max abs diff from sinf " + json.dumps(diff), flush=True)
        totals[label] = total
        print(f"[snake-probe] {label} total ms: "
              + json.dumps({n: round(v, 4) for n, v in total.items()}), flush=True)
    print(json.dumps({"snake_probe": totals, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
