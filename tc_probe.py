#!/usr/bin/env python3
"""How the tensor-core kernels' time moves with their launch shape (card
only).

    python3 tc_probe.py

The mma snake (csrc/snake_alias_mma.cu): copies under build/tc_probe/ that
ask ptxas for 2, 3 (as shipped) or 4 resident blocks an SM through
__launch_bounds__, each launched with a grid of that many blocks an SM
(as shipped: the warps walk their segments at the grid's stride) and, for
the shipped copy, with 12 blocks an SM and with one segment a warp; timed at
the five stage shapes of a 1020-frame chunk against the direct kernel.

The fused AMP iteration (csrc/amp_iter.cu): the package's kernel at other
tiles than ops/amp_cuda.py::amp_tile picks, and copies at the planned tile:
"mtw_fewer", whose warps hold fewer m-tiles at once (2 and 1 for up to two
and for three or four n-tiles, against 4 and 2), and three that leave out one part of the work to
show what it costs (their outputs are wrong): "no_snakes" (both snake
stages), "no_mixes" (both channel mixes with their weight staging) and
"no_weight_loads" (the staging's global loads alone); at the chunk's C = 20
and C = 10 stages, k = 3, 7, 11, d = 1 and 5.

Float32, CUDA events over rotated inputs (cold L2), the variants of one
shape in turns on the same inputs; prints us per call, and each variant's
max abs difference from the shipped kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "tc_probe"
SPIN_CYCLES = 200_000_000
CHUNK = [((1, 160, 5100), 18), ((1, 80, 20400), 18), ((1, 40, 81600), 18),
         ((1, 20, 163200), 18), ((1, 10, 326400), 19)]
# mma: (launch-bound blocks, grid blocks an SM; 0: one segment a warp)
MMA_VARIANTS = {"shipped": (3, 3), "grid12": (3, 12), "grid_full": (3, 0),
                "lb2": (2, 2), "lb4": (4, 4)}
AMP_STAGES = [(1, 20, 163200), (1, 10, 326400)]
AMP_TILES = {20: (104, 128, 168, 208, 248), 10: (208, 312, 416, 512)}
AMP_KD = [(3, 1), (3, 5), (7, 1), (7, 5), (11, 1), (11, 5)]
# copies of amp_iter.cu: (text, its replacement)
AMP_VARIANTS = {
    "mtw_fewer": ("constexpr int MTW = NT <= 2 ? 4 : 2;", "constexpr int MTW = NT <= 2 ? 2 : 1;"),
    "no_snakes": ("  const int n_seg = (L + kSegLen - 1) / kSegLen;\n",
                  "  const int n_seg = (L + kSegLen - 1) / kSegLen;\n  if (n_seg > 0) return;\n"),
    "no_mixes": ("  const int kc = k * channels, nks = ksteps(channels, k);\n",
                 "  const int kc = k * channels, nks = ksteps(channels, k);\n"
                 "  if (nks > 0) return;\n"),
    "no_weight_loads": ("wsm[i] = wfrag[s0 * kStepFrags + i];",
                        "wsm[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);"),
}


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


def in_turns(fns: dict, iters: int) -> dict:
    """us per call of each function, timed in turns (each twice)."""
    names = list(fns)
    times = dict.fromkeys(names, 0.0)
    for n in names + names[::-1]:
        times[n] += cuda_ms(fns[n], iters) * 1e3 / 2
    return times


def copy_sources(name: str, edits: dict[str, tuple[str, str]]) -> dict[str, Path]:
    """The package's sources under build/tc_probe/<name>/, each file's one
    (old, new) edit applied (the old text must be there)."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "snake_alias.cuh").write_text((snake_cuda.CSRC / "snake_alias.cuh").read_text())
    out = {}
    for f, (old, new) in edits.items():
        text = (snake_cuda.CSRC / f).read_text()
        if old not in text:
            raise SystemExit(f"tc_probe: {f} no longer holds {old!r}")
        (d / f).write_text(text.replace(old, new))
        out[f] = d / f
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    lb = "__launch_bounds__(kThreads, 3)"
    mma_src = {n: copy_sources(f"mma_lb{b}", {"snake_alias_mma.cu": (
        lb, f"__launch_bounds__(kThreads, {b})")})["snake_alias_mma.cu"]
        for n, (b, _) in MMA_VARIANTS.items()}
    amp_src = {n: copy_sources(f"amp_{n}", {"amp_iter.cu": edit})["amp_iter.cu"]
               for n, edit in AMP_VARIANTS.items()}
    snake_cuda.build(*sorted(set(mma_src.values())), *amp_src.values())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptr, num = ctypes.c_void_p, ctypes.c_int
    taps = ctypes.POINTER(ctypes.c_float)
    mma_libs = {n: snake_cuda.load_library(p, "snake_alias_mma_forward",
                                           [ptr] * 5 + [taps] + [num] * 7 + [ptr],
                                           "snake_alias_mma_error_string")
                for n, p in mma_src.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": smi, "mma": {}, "amp": {}}

    totals = dict.fromkeys(list(MMA_VARIANTS) + ["direct"], 0.0)
    for shape, calls in CHUNK:
        b, c, t = shape
        alpha = torch.randn(c, device="cuda", generator=g) * 0.3
        beta = torch.randn(c, device="cuda", generator=g) * 0.3
        n_buf = max(1, -(-100_000_000 // (b * c * t * 4)))
        xs = [torch.randn(shape, device="cuda", generator=g) * 1.5 for _ in range(n_buf)]
        plan = snake_cuda.snake_plan(b, c, t, 4)

        def mma(n, x):
            per_sm = MMA_VARIANTS[n][1]
            blocks = per_sm * sms if per_sm else -(-plan.warps // snake_cuda.WARPS)
            return snake_cuda._launch_forward(
                "snake_alias_mma", lambda: mma_libs[n], x, alpha, beta,
                before_taps=(snake_cuda._fir_device(x.device).data_ptr(),),
                after_shape=(plan.n_seg, snake_cuda.SEG_LEN, blocks))

        fns = {n: (lambda i=0, n=n: mma(n, xs[i % n_buf])) for n in MMA_VARIANTS}
        fns["direct"] = lambda i=0: snake_cuda.snake_alias_cuda(xs[i % n_buf], alpha, beta)
        ref = fns["shipped"]()
        diff = {n: (fns[n]() - ref).abs().max().item() for n in fns}
        times = in_turns(fns, 20)
        for n in fns:
            totals[n] += calls * times[n] / 1e3
        print(f"[tc-probe] mma {list(shape)} us per call "
              + json.dumps({n: round(v, 2) for n, v in times.items()})
              + " max abs diff " + json.dumps(diff), flush=True)
    result["mma"] = totals
    print("[tc-probe] mma ms per chunk " + json.dumps({n: round(v, 4) for n, v in totals.items()}),
          flush=True)

    amp_lib = amp_cuda._library()
    amp_libs = {n: snake_cuda.load_library(p, "amp_iter_forward",
                                           [ptr] * 11 + [taps] + [num] * 7 + [ptr],
                                           "amp_iter_error_string")
                for n, p in amp_src.items()}
    for b, c, t in AMP_STAGES:
        for k, d in AMP_KD:
            r = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
            params = [p.contiguous() for p in (r(c, c, k) * 0.1, r(c) * 0.1, r(c) * 0.3,
                                               r(c) * 0.3, r(c, c, k) * 0.1, r(c) * 0.1,
                                               r(c) * 0.3, r(c) * 0.3)]
            xs = [r(b, c, t) for _ in range(8)]
            wfrag = torch.empty(amp_cuda.wfrag_floats(c, k), device="cuda")
            planned = amp_cuda.amp_tile(b, c, t, k, d, sms)

            def amp(lib, tile, x):
                out = torch.empty_like(x)
                err = lib.amp_iter_forward(
                    x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params),
                    wfrag.data_ptr(), snake_cuda._taps(), 0, b, c, t, k, d, tile,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(lib.amp_iter_error_string(err).decode())
                return out

            fns = {}
            for tile in sorted(set(AMP_TILES[c] + (planned,))):
                try:
                    amp(amp_lib, tile, xs[0])
                except RuntimeError as e:
                    print(f"[tc-probe] amp {[b, c, t, k, d]} tile {tile}: {e}", flush=True)
                    continue
                fns[f"tile{tile}"] = lambda i=0, tile=tile: amp(amp_lib, tile, xs[i % 8])
            for n, lib in amp_libs.items():
                fns[n] = lambda i=0, lib=lib: amp(lib, planned, xs[i % 8])
            ref = amp(amp_lib, planned, xs[0])
            diff = {n: (fns[n]() - ref).abs().max().item() for n in fns}
            times = in_turns(fns, 20)
            result["amp"][f"{c},{k},{d}"] = dict(planned=planned, us=times)
            print(f"[tc-probe] amp {[b, c, t, k, d]} planned tile {planned}: us per call "
                  + json.dumps({n: round(v, 2) for n, v in times.items()})
                  + " max abs diff " + json.dumps(diff), flush=True)
    print(json.dumps({"tc_probe": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
