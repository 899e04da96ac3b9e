#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):
1. device: CUDA must be present (no CPU fallback); prints the card's name and
   power limit from nvidia-smi;
2. build: compiles csrc/snake_alias.cu with nvcc and times the build;
3. kernel vs plain: the snake kernel against its plain PyTorch version at the
   five base-width stage shapes of a 1020-frame chunk and at odd shapes, in
   float32 and bfloat16, with CUDA-event times (inputs rotated over >100 MB
   so that the 50 MB L2 is cold; in the pipeline the input may still sit in
   L2 after the convolution that wrote it);
4. requests: seeded random weights at full configs/base.yaml width through
   `svc_infer`: 30.5 s, 12.3 s and 2 s of features with unvoiced runs
   (7 chunks of 1000 frames); checks finite, non-silent output of
   frames * 320 samples and 91 snake launches per chunk; prints wall ms per
   request after a warm-up and the realtime factor, then a torch.profiler
   table of one chunk's device time;
5. card vs CPU: the 2 s request (out_chunk=200) on the card and on the CPU,
   compared at float32 tolerance, which TF32 convolutions are expected to
   exceed.

Then prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.nn.snake import snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import snake_cuda
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per output element: two 6-tap up FIRs (24), snake on two phases (2 x 5,
# counting sin as one), two 6-tap down FIRs (24)
SNAKE_OPS_PER_ELEM = 58
# kernel vs plain on the same inputs. f32: FMA contraction and sinf/expf
# rounding, a few ulp of outputs up to ~10. bf16: the two sides round the
# same f32 result to bf16, which may land one bf16 ulp apart (2^-8 relative).
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# card vs CPU waveform (tanh output in [-1, 1]): float32 convolutions summed
# in other orders through ~60 layers (3.6e-6 measured on an H100); TF32 keeps
# ~3 decimal digits, so TF32 convolutions are expected far above this
CARD_VS_CPU_ATOL = 5e-5

# ~0.1 s at the H100's clock: longer than the host takes to enqueue a timing loop
SPIN_CYCLES = 200_000_000

CHUNK_FRAMES = 1020  # out_chunk 1000 + 2 * hop_frame 10
# 4 + 2 + 1 chunks. The reference's chunk walk repeats frames for lengths in
# (3000, 3010), so the long request is 3050 frames, where output = frames * hop.
REQUEST_FRAMES = (3050, 1230, 200)
ODD_SHAPES = ((1, 8, 130), (1, 80, 20401), (2, 16, 1024))
REPLACES = "whisper_vits_svc_tpu/ops/pallas_snake.py:596"
SOURCE = "whisper_vits_svc_tpu_torch/csrc/snake_alias.cu"


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run without the final line (also under -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stage_shapes(hp) -> list[tuple[tuple[int, int, int], int]]:
    """((1, C, T), snake calls) per generator stage of one chunk."""
    out, t = [], CHUNK_FRAMES
    n_act = 2 * sum(len(d) for d in hp.gen.resblock_dilation_sizes)
    for i, u in enumerate(hp.gen.upsample_rates):
        t *= u
        c = hp.gen.upsample_initial_channel // 2 ** (i + 1)
        out.append(((1, c, t), n_act))
    shape, n = out[-1]
    out[-1] = (shape, n + 1)  # activation_post
    return out


def cuda_ms(fn, iters: int) -> float:
    """Device time per call: a spin kernel keeps the card busy while the host
    enqueues all `iters` calls, so the events time the card alone."""
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


def bound_ms(shape, dtype) -> tuple[float, str]:
    n = int(np.prod(shape))
    byte_s = 2 * n * torch.tensor([], dtype=dtype).element_size() / HBM_BYTES_PER_S
    op_s = n * SNAKE_OPS_PER_ELEM / F32_OPS_PER_S
    return max(byte_s, op_s) * 1e3, ("bytes" if byte_s >= op_s else "operations")


def check_kernel(shape, dtype, seed: int) -> dict:
    """Kernel vs plain on the same inputs; returns errors and times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t = shape
    alpha = torch.randn(c, device="cuda", generator=g) * 0.3
    beta = torch.randn(c, device="cuda", generator=g) * 0.3
    n_buf = max(1, -(-100_000_000 // (b * c * t * 4)))
    xs = [(torch.randn(shape, device="cuda", generator=g) * 1.5).to(dtype) for _ in range(n_buf)]
    got = snake_cuda.snake_alias_cuda(xs[0], alpha, beta)
    want = snake_alias_fused_cm(xs[0].float(), alpha, beta).to(dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake kernel disagrees at {shape} {dtype}: max abs err {err}")
    iters = 50 if b * c * t < 2_000_000 else 20
    k_ms = cuda_ms(lambda i=0: snake_cuda.snake_alias_cuda(xs[i % n_buf], alpha, beta), iters)
    p_ms = cuda_ms(lambda i=0: snake_alias_fused_cm(xs[i % n_buf], alpha, beta), iters)
    bnd, by = bound_ms(shape, dtype)
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
                kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by)


def features(hp, frames: int, seed: int):
    """Seeded features: F0 110-440 Hz with vibrato and 40-frame unvoiced
    runs every 300 frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    pit = (220.0 * 2 ** np.sin(2 * np.pi * t / 400.0) * (1 + 0.02 * np.sin(t / 3.0)))
    pit[(t % 300) >= 260] = 0.0
    spk = rng.standard_normal(hp.vits.spk_dim) / np.sqrt(hp.vits.spk_dim)
    ppg = rng.standard_normal((frames, hp.vits.ppg_dim)) * 0.5
    vec = rng.standard_normal((frames, hp.vits.vec_dim)) * 0.5
    return (spk.astype(np.float32), pit.astype(np.float32), ppg.astype(np.float32),
            vec.astype(np.float32))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = snake_cuda.build()
    snake_cuda._library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    hp = config_from_dict(BASE_MODEL_CONFIG)
    stages = stage_shapes(hp)
    rows = []
    for i, (shape, _) in enumerate(stages):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=i))
    for i, shape in enumerate(ODD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=100 + i))
    for r in rows:
        print("[kernel] " + json.dumps(r), flush=True)
    per_chunk = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for shape, calls in stages:
        r = next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == "float32")
        per_chunk["ms"] += calls * r["kernel_ms"]
        per_chunk["plain_ms"] += calls * r["plain_ms"]
        per_chunk["bound_ms"] += calls * r["bound_ms"]
        bound_by.add(r["bound_by"])
    n_calls = sum(calls for _, calls in stages)
    print(f"[kernel] per 1020-frame chunk, f32, {n_calls} calls: {json.dumps(per_chunk)}",
          flush=True)

    # requests at full base width on the card
    model = pipeline.build_infer_model(hp, device="cuda", seed=0)
    run = dict(hp=hp, device="cuda")
    reqs = [features(hp, frames, seed=i) for i, frames in enumerate(REQUEST_FRAMES)]
    pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run)  # warm-up
    torch.cuda.synchronize()
    snake_cuda.launches = 0
    total_chunks, total_audio_s, total_wall_s = 0, 0.0, 0.0
    for frames, (spk, pit, ppg, vec) in zip(REQUEST_FRAMES, reqs):
        t0 = time.perf_counter()
        audio = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = len(pipeline._chunk_plan(frames, 1000, 10))
        audio_s = frames * hp.data.hop_length / hp.data.sampling_rate
        rms = float(np.sqrt(np.mean(np.square(audio))))
        check(audio.shape == (frames * hp.data.hop_length,), f"output shape {audio.shape}")
        check(bool(np.isfinite(audio).all()), "non-finite samples")
        check(rms > 1e-3, f"silent output (rms {rms})")
        total_chunks += chunks
        total_audio_s += audio_s
        total_wall_s += wall
        print(f"[request] {frames} frames ({audio_s:.2f} s audio, {chunks} chunks): "
              f"{wall * 1e3:.2f} ms wall, realtime x{audio_s / wall:.2f}, rms {rms:.4f}",
              flush=True)
    launches = snake_cuda.launches
    check(launches == 91 * total_chunks,
          f"{launches} snake launches for {total_chunks} chunks, expected 91 per chunk")
    print(f"[requests] {total_chunks} chunks, snake launches {launches} "
          f"(91 per chunk), realtime x{total_audio_s / total_wall_s:.2f} overall", flush=True)

    # where one chunk's device time goes (the 2 s request, one chunk)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12,
                                    max_name_column_width=48), flush=True)
    print(f"[profile] 200-frame request: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), profiler on", flush=True)

    # the 2 s request on the card and on the CPU, same weights, features, noise
    short = dict(hp=hp, out_chunk=200)
    card = pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], device="cuda", **short)
    cpu_model = pipeline.build_infer_model(hp, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu = pipeline.svc_infer(cpu_model, DummyRetrieval(), *reqs[-1], device="cpu", **short)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    print(f"[card-vs-cpu] 200 frames: max abs err {err:.3e} (tolerance {CARD_VS_CPU_ATOL}), "
          f"cpu {cpu_s:.2f} s", flush=True)
    check(err <= CARD_VS_CPU_ATOL, f"card vs CPU max abs err {err}")

    kernels = [{
        "name": "snake_alias", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "ms": per_chunk["ms"], "plain_ms": per_chunk["plain_ms"],
        "bound_ms": per_chunk["bound_ms"], "bound_by": "/".join(sorted(bound_by)),
        "library_ms": None,
        "per": f"one {CHUNK_FRAMES}-frame chunk at base width, float32, {n_calls} calls",
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
