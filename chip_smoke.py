#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):
1. device: CUDA must be present (no CPU fallback); prints the card's name and
   power limit from nvidia-smi;
2. build: compiles csrc/snake_alias.cu and csrc/snake_alias_bwd.cu with nvcc,
   one process per source, started together, and times the build;
3. kernel vs plain: the snake kernel against its plain PyTorch version at the
   five base-width stage shapes of a 1020-frame chunk and at odd shapes, in
   float32 and bfloat16, with CUDA-event times (inputs rotated over >100 MB
   so that the 50 MB L2 is cold; in the pipeline the input may still sit in
   L2 after the convolution that wrote it);
4. backward kernel vs plain: the snake backward kernel against
   torch.autograd.grad of the plain version at the five stage shapes of a
   training step (batch 16, 25-frame segments) and at the JAX package's test
   shapes, float32 and bfloat16; dalpha and dbeta must be bitwise equal
   across two calls; CUDA-event times as in phase 3; the forward kernel
   against its plain version at the same five training shapes, as in
   phase 3;
5. requests: seeded random weights at full configs/base.yaml width through
   `svc_infer`: 30.5 s, 12.3 s and 2 s of features with unvoiced runs
   (7 chunks of 1000 frames); checks finite, non-silent output of
   frames * 320 samples, 91 snake launches per chunk and no backward launch;
   prints wall ms per request after a warm-up and the realtime factor, then a
   torch.profiler table of one chunk's device time;
6. card vs CPU: the 2 s request (out_chunk=200) on the card and on the CPU,
   compared at float32 tolerance, which TF32 convolutions are expected to
   exceed;
7. training steps: `init_train_states` + `make_train_step` at full
   configs/base.yaml width (batch 16, accum_step 2) on synthetic 300-frame
   utterances; one warm-up step, then 4 timed steps; checks finite losses
   and grad norms, 91 forward and 91 backward snake launches per step,
   finite non-zero gradients for every snake alpha and beta, D moving on
   every step and G on every accum_step-th step only; prints ms per step,
   utterances per second, peak device memory and a torch.profiler table of
   one more step;
8. training card vs CPU: the seeded initial weights, a 2 x 100-frame batch,
   every stochastic node frozen, the CPU taking the card's ReLU/abs
   branches; loss terms within rtol 1e-4; G's backward of one fixed audio gradient within
   relative L2 1e-4 per parameter; each audio loss term's gradient with
   respect to the audio, and every parameter gradient of the step, within
   relative L2 1e-3.

Then prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models.synthesizer import slice_segments
from whisper_vits_svc_tpu_torch.nn.snake import snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import snake_cuda
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per output element: two 6-tap up FIRs (24), snake on two phases (2 x 5,
# counting sin as one), two 6-tap down FIRs (24)
SNAKE_OPS_PER_ELEM = 58
# backward, per element: two 6-tap up FIRs recomputed (24), two 6-tap
# down-FIR adjoints (24), on two phases sincos and du = ds (1 + ib a sin 2au)
# (2 x 9) and the dalpha/dbeta terms (2 x 6), two 6-tap up-FIR adjoints (24)
SNAKE_BWD_OPS_PER_ELEM = 102
# kernel vs plain on the same inputs. f32: FMA contraction and sinf/expf
# rounding, a few ulp of outputs up to ~10. bf16: the two sides round the
# same f32 result to bf16, which may land one bf16 ulp apart (2^-8 relative).
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# backward kernel vs plain backward in f32, as the JAX package holds its
# backward kernel to jax.grad (tests/test_snake_fused.py:189): dalpha/dbeta
# are sums over B*T terms taken in another order
BWD_F32_TOL = dict(atol=3e-4, rtol=2e-4)
# card vs CPU waveform (tanh output in [-1, 1]): float32 convolutions summed
# in other orders through ~60 layers (3.6e-6 measured on an H100); TF32 keeps
# ~3 decimal digits, so TF32 convolutions are expected far above this
CARD_VS_CPU_ATOL = 5e-5
# training step card vs CPU, every ReLU, leaky ReLU and abs on the CPU taking
# the branch it took on the card (an input within f32 rounding of zero can
# take the other one, and the gradient there then changes by (1 - slope)
# of its size: kink_flips.py). Loss terms within 1e-4. G's own backward (its
# VJP of one fixed d loss / d audio, through the snake kernels) within 1e-4
# relative L2 per parameter. Each audio loss term's gradient with respect to
# the audio, and every parameter gradient of the step, within 1e-3: the
# MR-STFT log-magnitude loss divides by magnitudes down to its 3e-4 floor,
# so its audio gradient carries the f32 rounding of long DFT sums, which
# differs between cuBLAS and the CPU, into the generator's gradients.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_VJP_REL_L2 = 1e-4
TRAIN_GRAD_REL_L2 = 1e-3
# d loss / d (attention conv_k.bias) is zero in exact arithmetic: the bias
# adds q.b to every score of a query's row, which the softmax cancels. Both
# sides hold rounding noise there, so each side's norm is held under
# TRAIN_GRAD_REL_L2 of the same layer's conv_q.bias gradient instead.
ZERO_GRAD_SUFFIX = ".conv_k.bias"

# ~0.1 s at the H100's clock: longer than the host takes to enqueue a timing loop
SPIN_CYCLES = 200_000_000

CHUNK_FRAMES = 1020  # out_chunk 1000 + 2 * hop_frame 10
# 4 + 2 + 1 chunks. The reference's chunk walk repeats frames for lengths in
# (3000, 3010), so the long request is 3050 frames, where output = frames * hop.
REQUEST_FRAMES = (3050, 1230, 200)
ODD_SHAPES = ((1, 8, 130), (1, 80, 20401), (2, 16, 1024))
# the JAX package's backward test shapes (tests/test_snake_fused.py:171-191)
BWD_ODD_SHAPES = ((1, 10, 700), (2, 16, 1024), (1, 3, 130), (2, 20, 4000))
TRAIN_FRAMES = 300  # 3 s utterances, as bench_train.py:22
TIMED_STEPS = 4
CHECK_BATCH, CHECK_FRAMES, CHECK_SLICE_IDS = 2, 100, (0, 61)
REPLACES = "whisper_vits_svc_tpu/ops/pallas_snake.py:596"
SOURCE = "whisper_vits_svc_tpu_torch/csrc/snake_alias.cu"
REPLACES_BWD = "whisper_vits_svc_tpu/ops/pallas_snake.py:438"
SOURCE_BWD = "whisper_vits_svc_tpu_torch/csrc/snake_alias_bwd.cu"


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run without the final line (also under -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stage_shapes(hp, batch: int, frames: int) -> list[tuple[tuple[int, int, int], int]]:
    """((batch, C, T), snake calls) per generator stage for `frames` latent
    frames."""
    out, t = [], frames
    n_act = 2 * sum(len(d) for d in hp.gen.resblock_dilation_sizes)
    for i, u in enumerate(hp.gen.upsample_rates):
        t *= u
        c = hp.gen.upsample_initial_channel // 2 ** (i + 1)
        out.append(((batch, c, t), n_act))
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    byte_s, op_s = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
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
    n = b * c * t
    bnd, by = bound_ms(2 * n * xs[0].element_size(), n * SNAKE_OPS_PER_ELEM)
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
                kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by)


def check_bwd_kernel(shape, dtype, seed: int) -> dict:
    """Backward kernel vs plain backward (autograd through the plain forward,
    in float32 on the same rounded inputs); bitwise-equal dalpha/dbeta across
    two calls; returns errors and times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t = shape
    alpha = torch.randn(c, device="cuda", generator=g) * 0.3
    beta = torch.randn(c, device="cuda", generator=g) * 0.3
    n_buf = min(256, max(1, -(-100_000_000 // (2 * b * c * t * 4))))
    xs = [(torch.randn(shape, device="cuda", generator=g) * 1.5).to(dtype) for _ in range(n_buf)]
    dys = [torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(n_buf)]
    got = snake_cuda.snake_alias_bwd_cuda(xs[0], alpha, beta, dys[0])
    again = snake_cuda.snake_alias_bwd_cuda(xs[0], alpha, beta, dys[0])
    want = snake_cuda.snake_alias_bwd_plain(xs[0].float(), alpha, beta, dys[0].float())
    want = (want[0].to(dtype), want[1], want[2])
    torch.cuda.synchronize()
    tol = BWD_F32_TOL if dtype == torch.float32 else BF16_TOL
    errs = {}
    for name, a, w in zip(("dx", "dalpha", "dbeta"), got, want):
        errs[name] = (a.float() - w.float()).abs().max().item()
        check(torch.allclose(a.float(), w.float(), **tol),
              f"snake backward kernel disagrees on {name} at {shape} {dtype}: "
              f"max abs err {errs[name]}")
    check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
          f"dalpha/dbeta differ between two calls at {shape} {dtype}")
    iters = 50 if b * c * t < 2_000_000 else 20
    k_ms = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_cuda(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    p_ms = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_plain(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    n = b * c * t
    # x and dy read once, dx written once; alpha, beta read, dalpha, dbeta written
    bnd, by = bound_ms(3 * n * xs[0].element_size() + 4 * c * 4, n * SNAKE_BWD_OPS_PER_ELEM)
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."),
                max_abs_err=max(errs.values()), errs=errs, kernel_ms=k_ms, plain_ms=p_ms,
                bound_ms=bnd, bound_by=by)


def per_call_sum(rows, stages) -> tuple[dict, str]:
    """Kernel, plain and bound ms summed over the calls of `stages`, f32."""
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for shape, calls in stages:
        r = next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == "float32")
        total["ms"] += calls * r["kernel_ms"]
        total["plain_ms"] += calls * r["plain_ms"]
        total["bound_ms"] += calls * r["bound_ms"]
        bound_by.add(r["bound_by"])
    return total, "/".join(sorted(bound_by))


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


def train_batch(hp, batch: int, frames: int, seed: int) -> dict:
    """A synthetic training batch, as bench_train.py:44-56 makes it."""
    r = np.random.default_rng(seed)
    hop = hp.data.hop_length
    return dict(
        ppg=r.standard_normal((batch, frames, hp.vits.ppg_dim)).astype(np.float32) * 0.1,
        vec=r.standard_normal((batch, frames, hp.vits.vec_dim)).astype(np.float32) * 0.1,
        pit=r.uniform(100, 400, (batch, frames)).astype(np.float32),
        spk=r.standard_normal((batch, hp.vits.spk_dim)).astype(np.float32),
        spec=np.abs(r.standard_normal(
            (batch, frames, hp.data.filter_length // 2 + 1))).astype(np.float32),
        audio=(r.standard_normal((batch, frames * hop, 1)) * 0.2).astype(np.float32),
        ppg_l=np.full((batch,), frames, np.int32),
        spec_l=np.full((batch,), frames, np.int32),
    )


# device kernels by kind, from their names (first match wins)
KERNEL_KINDS = (
    ("snake_bwd", ("snake_alias_bwd",)),
    ("snake_fwd", ("snake_alias_kernel",)),
    ("conv", ("cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "conv")),
    ("matmul", ("gemm", "cutlass", "sm90_")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
)


def profile(fn) -> dict:
    """torch.profiler over fn(): the table by device time, wall ms, device
    busy ms (kernels, copies; no user-annotation ranges) and device ms by
    kernel kind."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS} | {"other": 0.0}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kind = next((k for k, keys in KERNEL_KINDS if any(key in e.name for key in keys)),
                    "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                      max_name_column_width=48)
    return dict(table=table, wall_ms=wall_us / 1e3, busy_ms=sum(kinds.values()),
                kinds=kinds)


def snake_param_indices(model) -> list[int]:
    return [i for i, (n, _) in enumerate(model.named_parameters())
            if n.endswith(".act.alpha") or n.endswith(".act.beta")]


def train_phase(hp) -> dict:
    """The training entry points at hp's width: one warm-up step, then
    TIMED_STEPS timed steps, then one profiled step. Returns the states and
    the numbers to report."""
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cuda")
    step = tstep.make_train_step(hp, g_state, d_state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_size, accum = hp.train.batch_size, hp.train.accum_step
    batches = [train_batch(hp, batch_size, TRAIN_FRAMES, seed=i)
               for i in range(TIMED_STEPS + 2)]

    n_snakes = sum(calls for _, calls in stage_shapes(hp, 1, 1))  # 91 at base width
    # every snake alpha/beta gradient that reaches G's optimizer, flattened
    snake_idx = snake_param_indices(g_state.model)
    check(len(snake_idx) == 2 * n_snakes,
          f"{len(snake_idx)} snake parameters in G, expected {2 * n_snakes}")
    snake_grads = []
    apply_g = g_state.apply_gradients

    def spy(grads):
        snake_grads.append(torch.cat([grads[i].flatten() for i in snake_idx]))
        return apply_g(grads)

    g_state.apply_gradients = spy

    def snapshot():
        return ([p.detach().clone() for p in g_state.model.parameters()],
                [p.detach().clone() for p in d_state.model.parameters()])

    def moved(before, model):
        return [not torch.equal(b, p.detach()) for b, p in zip(before, model.parameters())]

    step_ms = []
    for i, batch in enumerate(batches[: TIMED_STEPS + 1]):
        g_before, d_before = snapshot()
        fwd0, bwd0 = snake_cuda.launches, snake_cuda.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = snake_cuda.launches - fwd0, snake_cuda.launches_bwd - bwd0
        check(fwd == n_snakes and bwd == n_snakes,
              f"step {i}: {fwd} forward and {bwd} backward snake launches, "
              f"expected {n_snakes} each")
        metrics = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()), f"step {i}: non-finite {metrics}")
        g_moved, d_moved = moved(g_before, g_state.model), moved(d_before, d_state.model)
        check(all(d_moved), f"step {i}: {d_moved.count(False)} D parameters did not move")
        if (i + 1) % accum == 0:
            check(all(g_moved), f"step {i}: {g_moved.count(False)} G parameters did not move")
        else:
            check(not any(g_moved), f"step {i}: {sum(g_moved)} G parameters moved "
                                    f"between accumulation steps")
        grads = snake_grads[-1]
        check(bool(torch.isfinite(grads).all()) and bool((grads != 0).all()),
              f"step {i}: {int((~torch.isfinite(grads)).sum())} non-finite and "
              f"{int((grads == 0).sum())} zero snake alpha/beta gradients")
        print(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: {wall * 1e3:.2f} ms, "
              f"G stepped {all(g_moved)}, snake launches fwd {fwd} bwd {bwd}, "
              + json.dumps({k: round(v, 5) for k, v in metrics.items()}), flush=True)
        if i:
            step_ms.append(wall * 1e3)
        del g_before, d_before
    g_state.apply_gradients = apply_g

    torch.cuda.reset_peak_memory_stats()
    prof = profile(lambda: step(batches[TIMED_STEPS + 1], gen))
    return dict(g_state=g_state, d_state=d_state, step_ms=step_ms, profile=prof,
                peak_bytes=torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def branch_pattern(replay: list | None = None):
    """Record, in call order, the branch that every ReLU, leaky-ReLU and abs
    input takes (x > 0, or sign(x) for abs); or, given such a recording,
    make each call take the recorded branch, counting the inputs whose own
    branch differs. Yields {"taken": [...], "flips": n}."""
    state = {"taken": [], "flips": 0}
    calls = None if replay is None else iter(replay)
    # F.relu and nn.ReLU go through torch.relu
    orig = {"leaky_relu": F.leaky_relu, "relu": torch.relu, "abs": torch.abs}

    def wrap(name, fn):
        def wrapped(x, *args, **kwargs):
            own = torch.sign(x) if name == "abs" else x > 0
            if calls is None:
                state["taken"].append(own.cpu())
                return fn(x, *args, **kwargs)
            taken = next(calls).to(x.device)
            state["flips"] += int((taken != own).sum())
            if name == "abs":
                return x * taken
            slope = 0.0
            if name == "leaky_relu":
                slope = args[0] if args else kwargs.get("negative_slope", 0.01)
            return torch.where(taken, x, x * slope)
        return wrapped

    F.leaky_relu = wrap("leaky_relu", F.leaky_relu)
    torch.relu, torch.abs = wrap("relu", torch.relu), wrap("abs", torch.abs)
    try:
        yield state
    finally:
        F.leaky_relu, torch.relu, torch.abs = orig["leaky_relu"], orig["relu"], orig["abs"]


def train_card_vs_cpu(hp, g_model, d_model) -> dict:
    """loss_and_grads on the card and on the CPU, same batch, every
    stochastic node frozen, and every ReLU, leaky-ReLU and abs on the CPU
    taking the branch it took on the card. Both sides start from the seeded
    initial weights, loaded into the card's models, so that the reading does
    not depend on the card's non-deterministic weight-gradient sums in the
    steps before."""
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    g_cpu, d_cpu = g_state.model, d_state.model
    g_model.load_state_dict(g_cpu.state_dict())
    d_model.load_state_dict(d_cpu.state_dict())
    batch = train_batch(hp, CHECK_BATCH, CHECK_FRAMES, seed=99)
    frozen = dict(train=False, perturb=False, noise_scale=0.0)
    ids = torch.tensor(CHECK_SLICE_IDS)
    with branch_pattern() as card_branches:
        card = tstep.loss_and_grads(hp, g_model, d_model, batch, slice_ids=ids.cuda(),
                                    **frozen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with branch_pattern(replay=card_branches["taken"]) as cpu_branches:
        cpu = tstep.loss_and_grads(hp, g_cpu, d_cpu, batch, slice_ids=ids, **frozen)
    cpu_s = time.perf_counter() - t0
    loss_err = {k: abs(float(card[2][k]) - float(cpu[2][k])) / abs(float(cpu[2][k]))
                for k in cpu[2]}
    rel, zero = [], []
    for which, model, gc, gp in (("G", g_cpu, card[0], cpu[0]), ("D", d_cpu, card[1], cpu[1])):
        norms = {name: torch.linalg.vector_norm(b).item()
                 for (name, _), b in zip(model.named_parameters(), gp)}
        for (name, _), a, b in zip(model.named_parameters(), gc, gp):
            d = torch.linalg.vector_norm(a.cpu() - b).item()
            if name.endswith(ZERO_GRAD_SUFFIX):
                scale = norms[name.replace(".conv_k.", ".conv_q.")]
                size = max(torch.linalg.vector_norm(a).item(), norms[name])
                zero.append((size / scale, f"{which}:{name}"))
                continue
            n = norms[name]
            rel.append((d / n if n else (0.0 if d == 0 else float("inf")), f"{which}:{name}"))
    rel.sort(reverse=True)
    zero.sort(reverse=True)

    # where a difference enters: for the CPU's generated audio, each audio
    # loss term's gradient with respect to it on both sides, then G's VJP
    # of one fixed d loss / d audio on both sides
    def rel_l2(a, ref):
        return (torch.linalg.vector_norm(a.cpu() - ref) / torch.linalg.vector_norm(ref)).item()

    inputs = {k: torch.as_tensor(v) for k, v in batch.items()}
    args = [inputs[k] for k in ("ppg", "vec", "pit", "spec", "spk", "ppg_l", "spec_l")]
    out_cpu = g_cpu(*args, slice_ids=ids, **frozen)
    real = slice_segments(inputs["audio"], out_cpu.ids_slice * hp.data.hop_length,
                          hp.data.segment_size)
    audio_grads, taken = [], None
    for where, disc in (("cuda", d_model), ("cpu", d_cpu)):
        audio = out_cpu.fake_audio.detach().to(where).requires_grad_(True)
        with branch_pattern(replay=taken) as branches:
            terms = tstep.audio_losses(hp, disc, audio, real.to(where))
        taken = branches["taken"]
        audio_grads.append({k: torch.autograd.grad(terms[k], audio, retain_graph=True)[0]
                            for k in ("loss_m", "loss_s", "score_loss", "feat_loss")})
    term_rel = {k: rel_l2(audio_grads[0][k], v) for k, v in audio_grads[1].items()}
    d_audio = sum(audio_grads[1].values())
    out_card = g_model(*(a.cuda() for a in args), slice_ids=ids.cuda(), **frozen)
    vjp_card = torch.autograd.grad(out_card.fake_audio, list(g_model.parameters()),
                                   d_audio.cuda(), allow_unused=True)
    vjp_cpu = torch.autograd.grad(out_cpu.fake_audio, list(g_cpu.parameters()), d_audio,
                                  allow_unused=True)
    vjp_rel = sorted(((rel_l2(a, c), name) for (name, _), a, c
                      in zip(g_cpu.named_parameters(), vjp_card, vjp_cpu) if c is not None),
                     reverse=True)
    return dict(loss_rel=loss_err, grad_rel=rel, zero_rel=zero, flips=cpu_branches["flips"],
                kinks=sum(t.numel() for t in card_branches["taken"]), cpu_s=cpu_s,
                term_rel=term_rel, vjp_rel=vjp_rel)


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
    libs = snake_cuda.build()
    snake_cuda._library()
    snake_cuda._library_bwd()
    print(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    hp = config_from_dict(BASE_MODEL_CONFIG)
    stages = stage_shapes(hp, 1, CHUNK_FRAMES)
    rows = []
    for i, (shape, _) in enumerate(stages):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=i))
    for i, shape in enumerate(ODD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=100 + i))
    for r in rows:
        print("[kernel] " + json.dumps(r), flush=True)
    per_chunk, bound_by = per_call_sum(rows, stages)
    n_calls = sum(calls for _, calls in stages)
    print(f"[kernel] per 1020-frame chunk, f32, {n_calls} calls: {json.dumps(per_chunk)}",
          flush=True)

    # the backward kernel at a training step's shapes and the JAX test shapes
    seg_frames = hp.data.segment_size // hp.data.hop_length
    train_stages = stage_shapes(hp, hp.train.batch_size, seg_frames)
    bwd_rows = []
    for i, shape in enumerate([s for s, _ in train_stages] + list(BWD_ODD_SHAPES)):
        for dtype in (torch.float32, torch.bfloat16):
            bwd_rows.append(check_bwd_kernel(shape, dtype, seed=200 + i))
    for r in bwd_rows:
        print("[kernel-bwd] " + json.dumps(r), flush=True)
    per_step, bwd_bound_by = per_call_sum(bwd_rows, train_stages)
    n_train_calls = sum(calls for _, calls in train_stages)
    print(f"[kernel-bwd] per training step (batch {hp.train.batch_size}, {seg_frames}-frame "
          f"segments), f32, {n_train_calls} calls: {json.dumps(per_step)}", flush=True)
    # the forward kernel at the same training shapes
    fwd_train_rows = []
    for i, (shape, _) in enumerate(train_stages):
        for dtype in (torch.float32, torch.bfloat16):
            fwd_train_rows.append(check_kernel(shape, dtype, seed=300 + i))
    for r in fwd_train_rows:
        print("[kernel-train] " + json.dumps(r), flush=True)
    fwd_per_step, fwd_step_bound_by = per_call_sum(fwd_train_rows, train_stages)
    print(f"[kernel-train] forward per training step, f32, {n_train_calls} calls: "
          f"{json.dumps(fwd_per_step)}; backward {json.dumps(per_step)}", flush=True)

    # requests at full base width on the card
    model = pipeline.build_infer_model(hp, device="cuda", seed=0)
    run = dict(hp=hp, device="cuda")
    reqs = [features(hp, frames, seed=i) for i, frames in enumerate(REQUEST_FRAMES)]
    pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run)  # warm-up
    torch.cuda.synchronize()
    snake_cuda.launches = snake_cuda.launches_bwd = 0
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
    launches, infer_bwd = snake_cuda.launches, snake_cuda.launches_bwd
    check(launches == 91 * total_chunks,
          f"{launches} snake launches for {total_chunks} chunks, expected 91 per chunk")
    check(infer_bwd == 0, f"{infer_bwd} backward snake launches during inference")
    print(f"[requests] {total_chunks} chunks, snake launches {launches} "
          f"(91 per chunk), realtime x{total_audio_s / total_wall_s:.2f} overall", flush=True)

    # where one chunk's device time goes (the 2 s request, one chunk)
    prof = profile(lambda: pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run))
    print(prof["table"], flush=True)
    print(f"[profile] 200-frame request: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
          f"profiler on; device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()}), flush=True)

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
    del model, cpu_model

    # training steps at full base width on the card
    snake_cuda.launches = snake_cuda.launches_bwd = 0
    tr = train_phase(hp)
    train_fwd, train_bwd = snake_cuda.launches, snake_cuda.launches_bwd
    n_steps = TIMED_STEPS + 2  # warm-up, timed, profiled
    check(train_fwd == 91 * n_steps and train_bwd == 91 * n_steps,
          f"{train_fwd} forward / {train_bwd} backward snake launches in {n_steps} steps")
    ms_step = float(np.mean(tr["step_ms"]))
    utt_s = hp.train.batch_size / (ms_step / 1e3)
    print(f"[train] {TIMED_STEPS} timed steps, batch {hp.train.batch_size} x {TRAIN_FRAMES} "
          f"frames: {ms_step:.2f} ms per step (steps {[round(t, 2) for t in tr['step_ms']]}), "
          f"{utt_s:.2f} utterances/s, peak device memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; snake launches fwd {train_fwd} bwd {train_bwd} "
          f"in {n_steps} steps", flush=True)
    prof = tr["profile"]
    print(prof["table"], flush=True)
    print(f"[train-profile] one step: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
          f"profiler on; device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()}), flush=True)

    # the training step's losses and gradients on the card and on the CPU
    cmp = train_card_vs_cpu(hp, tr["g_state"].model, tr["d_state"].model)
    rel = [r for r, _ in cmp["grad_rel"]]
    within = float(np.mean(np.array(rel) <= TRAIN_GRAD_REL_L2))
    median = float(np.median(rel))
    worst_loss = max(cmp["loss_rel"].values())
    worst_term = max(cmp["term_rel"].values())

    def top(pairs, n):
        return [(float(f"{r:.3e}"), name) for r, name in pairs[:n]]

    print(f"[train-card-vs-cpu] {CHECK_BATCH} x {CHECK_FRAMES} frames, frozen noise, the CPU "
          f"taking the card's ReLU/leaky-ReLU/abs branches ({cmp['flips']} of {cmp['kinks']} "
          f"inputs differed): loss rel err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in cmp["loss_rel"].items()})
          + f"; grad rel L2 over {len(rel)} parameters: median {median:.3e}, "
          f"{100 * within:.2f}% within {TRAIN_GRAD_REL_L2}, worst {top(cmp['grad_rel'], 6)}; "
          f"d term / d audio rel L2 "
          + json.dumps({k: float(f"{v:.3e}") for k, v in cmp["term_rel"].items()})
          + f"; G's VJP of one d audio, worst of {len(cmp['vjp_rel'])} "
          f"{top(cmp['vjp_rel'], 3)}; conv_k.bias (zero in exact arithmetic) against "
          f"conv_q.bias {top(cmp['zero_rel'], 2)}; cpu {cmp['cpu_s']:.2f} s", flush=True)
    check(worst_loss <= TRAIN_LOSS_RTOL, f"training loss terms card vs CPU: {cmp['loss_rel']}")
    check(cmp["vjp_rel"][0][0] <= TRAIN_VJP_REL_L2,
          f"G's backward card vs CPU: {top(cmp['vjp_rel'], 5)}")
    check(worst_term <= TRAIN_GRAD_REL_L2,
          f"d loss term / d audio card vs CPU: {cmp['term_rel']}")
    check(rel[0] <= TRAIN_GRAD_REL_L2,
          f"training gradients card vs CPU: {100 * within:.2f}% within "
          f"{TRAIN_GRAD_REL_L2}, worst {top(cmp['grad_rel'], 5)}")
    check(cmp["zero_rel"][0][0] <= TRAIN_GRAD_REL_L2,
          f"conv_k.bias gradients not near zero: {top(cmp['zero_rel'], 3)}")

    kernels = [{
        "name": "snake_alias", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + fwd_train_rows
                           if r["dtype"] == "float32"),
        "ms": per_chunk["ms"], "plain_ms": per_chunk["plain_ms"],
        "bound_ms": per_chunk["bound_ms"], "bound_by": bound_by, "library_ms": None,
        "per": f"one {CHUNK_FRAMES}-frame chunk at base width, float32, {n_calls} calls",
        "launches_by_path": {"svc_infer": launches, "train_step": train_fwd},
        "train_step": fwd_per_step | {
            "bound_by": fwd_step_bound_by,
            "per": f"one training step at base width (batch {hp.train.batch_size}, "
                   f"{seg_frames}-frame segments), float32, {n_train_calls} calls"},
    }, {
        "name": "snake_alias_bwd", "route": "cuda", "source": SOURCE_BWD,
        "replaces": REPLACES_BWD, "launches": train_bwd,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "float32"),
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"], "bound_by": bwd_bound_by, "library_ms": None,
        "per": f"one training step at base width (batch {hp.train.batch_size}, "
               f"{seg_frames}-frame segments), float32, {n_train_calls} calls",
        "launches_by_path": {"svc_infer": infer_bwd, "train_step": train_bwd},
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
