#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):
1. device: CUDA must be present (no CPU fallback); prints the card's name and
   power limit from nvidia-smi;
2. build: compiles the five sources under csrc/ (snake_alias, snake_alias_bwd,
   snake_alias_strips, snake_alias_mma, amp_iter) with nvcc, one process per
   source, started together, and times the build; where build/prev_kernels/
   holds an earlier version's snake_alias_mma.cu, amp_iter.cu and
   snake_alias.cuh (a copy kept out of git), builds those two sources in
   the same batch;
3. kernel vs plain: the snake kernel against its plain PyTorch version at the
   five base-width stage shapes of a 1020-frame chunk and at odd shapes, in
   float32 and bfloat16, with CUDA-event times (inputs rotated over >100 MB
   so that the 50 MB L2 is cold; in the pipeline the input may still sit in
   L2 after the convolution that wrote it);
4. backward kernel vs plain: the snake backward kernel against
   torch.autograd.grad of the plain version at the five stage shapes of a
   training step (batch 16, 25-frame segments) and at the JAX package's test
   shapes, float32 and bfloat16; dalpha and dbeta must be bitwise equal
   across two calls; CUDA-event times as in phase 3 (the earlier kernel's
   beside them);
   the forward kernel against its plain version at the same five training
   shapes, as in phase 3;
4b. the corners of the kernels' work plan, forward and backward, float32
   and bfloat16, untimed: packed and misaligned rows (T = 1, T < 12,
   T = 32 * 8 +- 1, odd T with B * C no multiple of a block's 8 warps, the
   JAX package's backward test shapes), a tensor whose start is not 16-byte
   aligned, and large arguments (x * 100, e^alpha up to 4.5, beta down to
   -3: |e^alpha u| ~ 1e3, 1 / e^beta ~ 20), at the same tolerances;
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
   and grad norms, 91 forward and 91 backward snake launches per step (and
   in the profiled step 91 kernels of each: one kernel per backward call),
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

9. alternative kernels vs plain: the strips and the mma snake kernels at the
   five stage shapes, at odd shapes and at the JAX package's strips test
   shapes, float32 and bfloat16: strips bitwise equal to the direct kernel,
   mma within the float32 tolerance of the direct kernel and of the plain
   version, with the direct kernel's time on the same inputs beside theirs;
   the mma kernel also at large arguments (x * 100) and at a start off
   16-byte alignment; with build/prev_kernels/, the earlier mma kernel
   timed on the same inputs in turns (new, old, old, new);
   the fused AMP iteration against its plain version at the 18 (shape, k, d)
   cases of a chunk, at the JAX package's test shapes and at odd ones (T
   shorter than the halo, T = 1, C = 32, B = 2), at large arguments and at a
   start off 16-byte alignment, with its time, its two bounds (the mixes on
   the CUDA cores and as 3xTF32 on the tensor cores), the earlier kernel's
   time in turns (with build/prev_kernels/) and the time of the unfused
   route (two direct snake launches, two cuDNN float32 convolutions, the
   add);
10. alternative configurations: the same seeded weights through `svc_infer`
   with `amp_fused_iter=True`, `snake_variant="strips"` and
   `snake_variant="mma"` (1230, 200 and 1000 frames: 4 chunks each), every
   count set to 0 before each path; checks the launches per chunk (18
   amp_iter + 55 direct; 37 strips + 54 direct; 91 mma), each waveform
   within 5e-5 of the default configuration's on the card, and the fused
   one against the CPU on the 200-frame request; prints wall ms, the
   realtime factor and device ms per chunk beside the default's.

Then prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models.synthesizer import slice_segments
from whisper_vits_svc_tpu_torch.nn.snake import snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict
from whisper_vits_svc_tpu_torch.utils.device import resolve_device

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
# the work plan's corners: T = 1, T < 12, T = 32 * RUN +- 1 (a warp's lanes),
# T = SEG_LEN - 1 (rows whose aligned start needs a second segment), odd T
# with B * C no multiple of a block's WARPS
PLAN_ODD_SHAPES = ((1, 1, 1), (2, 3, 1), (1, 5, 5), (3, 3, 11),
                   (1, 3, 32 * snake_cuda.RUN - 1), (1, 3, 32 * snake_cuda.RUN + 1),
                   (2, 3, snake_cuda.SEG_LEN - 1), (3, 5, 131), (1, 7, 997))
# the large-argument inputs at a small, a short-row and a long shape
LARGE_ARG_SHAPES = ((2, 16, 1024), (16, 160, 125), (1, 20, 163200))
TRAIN_FRAMES = 300  # 3 s utterances, as bench_train.py:22
TIMED_STEPS = 4
CHECK_BATCH, CHECK_FRAMES, CHECK_SLICE_IDS = 2, 100, (0, 61)
# the JAX package's fused-iteration and strips test shapes
# (tests/test_snake_fused.py:230-231, :297-298) and odd ones: T no multiple of
# anything, T shorter than the halo, T = 1, C = 32, B = 2
AMP_ODD_CASES = ((1, 10, 1280, 3, 1), (2, 16, 1024, 7, 3), (1, 12, 2560, 11, 5),
                 (1, 10, 1279, 7, 3), (1, 10, 30, 11, 5), (1, 10, 1, 11, 5),
                 (2, 32, 3000, 11, 5))
# the fused iteration's large-argument and misaligned cases: a C = 20 and a
# C = 10 shape of the chunk's kinds, and the widest K (C = 32, k = 11)
AMP_CORNER_CASES = ((1, 20, 4000, 11, 5), (1, 10, 8000, 3, 1), (2, 32, 1000, 11, 5))
STRIPS_ODD_SHAPES = ((2, 10, 5120), (2, 20, 6400), (2, 6, 8192), (2, 10, 3200))
# fused iteration vs plain in f32, as the JAX package holds its kernel
# (tests/test_snake_fused.py:242)
AMP_F32_TOL = dict(atol=2e-5, rtol=1e-5)
ALT_REQUEST_FRAMES = (1230, 200, 1000)  # 2 + 1 + 1 chunks
# launches per 1020-frame chunk at base width: the fused iteration takes the
# C = 20 and C = 10 stages (2 x 9 iterations, 36 of the 91 snakes); strips
# takes the same stages' 36 snakes and activation_post; mma takes every snake
ALT_LAUNCHES_PER_CHUNK = {
    "fused": dict(amp=18, direct=55),
    "strips": dict(strips=37, direct=54),
    "mma": dict(mma=91),
}
ALT_CONFIGS = {
    "fused": dict(amp_fused_iter=True),
    "strips": dict(snake_variant="strips"),
    "mma": dict(snake_variant="mma"),
}
SNAKE_KERNELS = {"direct": snake_cuda.snake_alias_cuda,
                 "strips": snake_cuda.snake_alias_strips_cuda,
                 "mma": snake_cuda.snake_alias_mma_cuda}
REPLACES = "whisper_vits_svc_tpu/ops/pallas_snake.py:596"
SOURCE = "whisper_vits_svc_tpu_torch/csrc/snake_alias.cu"
REPLACES_BWD = "whisper_vits_svc_tpu/ops/pallas_snake.py:438"
SOURCE_BWD = "whisper_vits_svc_tpu_torch/csrc/snake_alias_bwd.cu"
REPLACES_AMP = "whisper_vits_svc_tpu/ops/pallas_amp.py:157"
SOURCE_AMP = "whisper_vits_svc_tpu_torch/csrc/amp_iter.cu"
REPLACES_STRIPS = "whisper_vits_svc_tpu/ops/pallas_snake.py:539"
SOURCE_STRIPS = "whisper_vits_svc_tpu_torch/csrc/snake_alias_strips.cu"
REPLACES_MMA = "whisper_vits_svc_tpu/ops/pallas_snake.py:280"
SOURCE_MMA = "whisper_vits_svc_tpu_torch/csrc/snake_alias_mma.cu"
# an earlier version's tensor-core snake and fused AMP kernels, for the
# comparison: a copy of their files (snake_alias_mma.cu, amp_iter.cu and the
# snake_alias.cuh they include) kept out of git (build/ is ignored)
PREV_DIR = Path(__file__).resolve().parent / "build" / "prev_kernels"
PREV_SOURCES = (PREV_DIR / "snake_alias_mma.cu", PREV_DIR / "amp_iter.cu")
# H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet); a 3xTF32 product
# takes three of its operations for each useful one
TF32_OPS_PER_S = 495e12


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


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    snake_cuda.launches = snake_cuda.launches_bwd = 0
    snake_cuda.launches_strips = snake_cuda.launches_mma = 0
    amp_cuda.launches = 0


def read_counts() -> dict:
    return dict(direct=snake_cuda.launches, bwd=snake_cuda.launches_bwd,
                strips=snake_cuda.launches_strips, mma=snake_cuda.launches_mma,
                amp=amp_cuda.launches)


def snake_params(c: int, g, large: bool = False):
    """alpha, beta [C]: small, or (large) e^alpha in [1.6, 4.5] and beta in
    [-3, 0]."""
    if large:
        return (1.0 + torch.rand(c, device="cuda", generator=g) - 0.5,
                -3.0 * torch.rand(c, device="cuda", generator=g))
    return (torch.randn(c, device="cuda", generator=g) * 0.3,
            torch.randn(c, device="cuda", generator=g) * 0.3)


def snake_inputs(shape, dtype, seed: int, large: bool = False, n_buf: int | None = None):
    """(rotating inputs over >100 MB, alpha, beta) for one snake shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t = shape
    alpha, beta = snake_params(c, g, large)
    n_buf = n_buf or max(1, -(-100_000_000 // (b * c * t * 4)))
    scale = 100.0 if large else 1.5
    xs = [(torch.randn(shape, device="cuda", generator=g) * scale).to(dtype)
          for _ in range(n_buf)]
    return xs, alpha, beta


def misalign(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose start lies 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    skip = 4 // x.element_size()
    out = flat[skip: skip + x.numel()].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 4, "misalign: the copy is 16-byte aligned")
    return out


def prev_fir_matrices() -> np.ndarray:
    """The earlier mma kernel's [B_up hi, B_up lo, B_dn hi, B_dn lo]: B_up
    [24, 32] (a window of 16 phases from P reads x[P - 3 + i]; columns
    0..15 se, 16..31 so) and B_dn [48, 16] (16 outputs from q read E[q - 2 +
    i] and O[q - 3 + i])."""
    from whisper_vits_svc_tpu_torch.nn.snake import _polyphase_taps
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    b_up = np.zeros((24, 32), np.float32)
    b_dn = np.zeros((48, 16), np.float32)
    for j in range(16):
        for m in range(6):
            b_up[j + m, j] = ae[m]
            b_up[j + m + 1, 16 + j] = ao[m]
            b_dn[j + m, j] = de[m]
            b_dn[24 + j + m, j] = do_[m]
    parts = []
    for mat in (b_up, b_dn):
        parts += [p.flatten() for p in snake_cuda.tf32_split(torch.from_numpy(mat))]
    return torch.cat(parts).numpy()


def prev_amp_tile(c: int, k: int, d: int) -> int:
    """The earlier fused AMP kernel's tile: at most 480 outputs, four
    [C, tile + 2 halo] buffers beside both kernels in a block's shared memory."""
    cp = 4 * -(-c // 4)
    halo = (k - 1) // 2 + 12 + d * (k - 1) // 2
    width = (232448 - 1024 - 4 * (2 * k * c * cp + 6 * cp)) // (16 * c)
    tile = min(480, width - 2 * halo)
    return tile - tile % 32


def load_prev() -> dict | None:
    """The earlier tensor-core snake and fused AMP kernels from
    build/prev_kernels/ (built with the others in the build phase; their C
    ABI: the mma kernel one block per 1024-output tile, the fused kernel
    with its own tile and no fragment scratch) behind wrappers, or None
    where the directory is absent (a checkout from git)."""
    if not all(p.exists() for p in (*PREV_SOURCES, PREV_DIR / "snake_alias.cuh")):
        return None
    ptr, num = ctypes.c_void_p, ctypes.c_int
    taps = ctypes.POINTER(ctypes.c_float)
    mma_lib = snake_cuda.load_library(PREV_SOURCES[0], "snake_alias_mma_forward",
                                      [ptr] * 5 + [taps] + [num] * 4 + [ptr],
                                      "snake_alias_mma_error_string")
    amp_lib = snake_cuda.load_library(PREV_SOURCES[1], "amp_iter_forward",
                                      [ptr] * 10 + [taps] + [num] * 7 + [ptr],
                                      "amp_iter_error_string")
    fir = torch.from_numpy(prev_fir_matrices()).cuda()

    def mma(x, alpha, beta):
        return snake_cuda._launch_forward("snake_alias_mma", lambda: mma_lib, x, alpha, beta,
                                          before_taps=(fir.data_ptr(),))

    def amp(x, *args):
        *params, k, d = args
        b, c, t = x.shape
        out = torch.empty_like(x)
        params = [snake_cuda._param(p, x.device) for p in params]
        err = amp_lib.amp_iter_forward(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params), snake_cuda._taps(),
            int(x.dtype == torch.bfloat16), b, c, t, k, d, prev_amp_tile(c, k, d),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"earlier amp_iter kernel launch failed: {err}")
        return out

    return dict(mma=mma, amp=amp)


def timed_pair(row: dict, new, old, iters: int) -> None:
    """row["kernel_ms"] and, with `old`, row["prev_ms"]: timed in turns (new,
    old, old, new), each the mean of its two."""
    if old is None:
        row["kernel_ms"] = cuda_ms(new, iters)
        return
    k1, o1, o2, k2 = (cuda_ms(fn, iters) for fn in (new, old, old, new))
    row["kernel_ms"], row["prev_ms"] = (k1 + k2) / 2, (o1 + o2) / 2


def check_kernel(shape, dtype, seed: int, variant: str = "direct", prev: dict | None = None
                 ) -> dict:
    """A forward snake kernel vs plain on the same inputs; "strips" and "mma"
    also vs the direct kernel (strips bitwise), with its time on the same
    inputs; with `prev` (a dict holding an earlier kernel of the variant)
    also the earlier kernel's result and time on the same inputs.
    Returns errors and times."""
    fn = SNAKE_KERNELS[variant]
    xs, alpha, beta = snake_inputs(shape, dtype, seed)
    b, c, t = shape
    n_buf = len(xs)
    got = fn(xs[0], alpha, beta)
    want = snake_alias_fused_cm(xs[0].float(), alpha, beta).to(dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake {variant} kernel disagrees at {shape} {dtype}: max abs err {err}")
    iters = 50 if b * c * t < 2_000_000 else 20
    row = dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), max_abs_err=err)
    if variant != "direct":
        direct = snake_cuda.snake_alias_cuda(xs[0], alpha, beta)
        row["vs_direct"] = (got.float() - direct.float()).abs().max().item()
        same = (torch.equal(got, direct) if variant == "strips"
                else torch.allclose(got.float(), direct.float(), **tol))
        check(same, f"snake {variant} kernel against direct at {shape} {dtype}: max abs diff "
                    f"{row['vs_direct']}" + (", not bitwise equal" if variant == "strips" else ""))
        row["direct_ms"] = cuda_ms(
            lambda i=0: snake_cuda.snake_alias_cuda(xs[i % n_buf], alpha, beta), iters)
        if variant == "strips":
            row["fold"] = snake_cuda.strip_fold(c, t, b)
            # any fold: segments that end inside a tile
            odd = snake_cuda.snake_alias_strips_cuda(xs[0], alpha, beta, fold=min(7, t))
            check(torch.equal(odd, direct),
                  f"snake strips kernel with fold 7 is not bitwise equal to direct at {shape}")
    old = None
    if prev is not None:
        before = prev[variant](xs[0], alpha, beta)
        row["prev_err"] = (before.float() - got.float()).abs().max().item()
        check(torch.allclose(before.float(), got.float(), **tol),
              f"earlier {variant} kernel against the new one at {shape} {dtype}: "
              f"{row['prev_err']}")

        def old(i=0):
            return prev[variant](xs[i % n_buf], alpha, beta)
    timed_pair(row, lambda i=0: fn(xs[i % n_buf], alpha, beta), old, iters)
    row["plain_ms"] = cuda_ms(lambda i=0: snake_alias_fused_cm(xs[i % n_buf], alpha, beta), iters)
    n = b * c * t
    row["bound_ms"], row["bound_by"] = bound_ms(2 * n * xs[0].element_size(),
                                                n * SNAKE_OPS_PER_ELEM)
    return row


def amp_unfused(x, k1, b1, a1, be1, k2, b2, a2, be2, kernel_size: int, d: int):
    """One AMP iteration as the default path runs it on the card: two direct
    snake launches, two cuDNN convolutions (float32, TF32 off), the add."""
    xt = snake_cuda.snake_alias_cuda(x, a1, be1)
    xt = F.conv1d(xt, k1, b1, padding=(kernel_size * d - d) // 2, dilation=d)
    xt = snake_cuda.snake_alias_cuda(xt, a2, be2)
    return F.conv1d(xt, k2, b2, padding=(kernel_size - 1) // 2) + x


def amp_bounds(b: int, c: int, t: int, k: int, itemsize: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, tensor-core bound ms) of one fused
    iteration: x read once, out written once, both kernels, biases and
    snake parameters read; per element two k-tap C x C mixes (2 k C FMAs =
    4 k C operations) and two snakes (2 x 58). The first bound takes the
    mixes at the f32 rate of the CUDA cores, the second at a third of the
    dense TF32 tensor-core rate (3xTF32), both counting no padding; the
    snakes at the f32 rate."""
    n = b * c * t
    bnd, by = bound_ms(2 * n * itemsize + 4 * (2 * k * c * c + 6 * c),
                       n * (4 * k * c + 2 * SNAKE_OPS_PER_ELEM))
    tc = (3 * n * 4 * k * c / TF32_OPS_PER_S + n * 2 * SNAKE_OPS_PER_ELEM / F32_OPS_PER_S) * 1e3
    return bnd, by, max(tc, (2 * n * itemsize) / HBM_BYTES_PER_S * 1e3)


def check_amp(case, dtype, seed: int, timed: bool, prev: dict | None = None,
              large: bool = False, misaligned: bool = False) -> dict:
    """amp_iter vs amp_iter_ref on the same inputs; with `timed` also the
    kernel's, the plain version's and the unfused route's times, and with
    `prev` the earlier kernel's result and time (in turns with the new one).
    `large`: x * 100, so that the first snake sees |e^alpha x| ~ 1e3, with
    the mixes' weights at 1e-3 so that the second snake's argument stays ~10
    (with the main cases' weights c1 reaches ~1e3, where the second snake is
    so ill-conditioned that the plain version in f32 misses its own f64
    value by several times the tolerance; tests/test_torch_tensor_core_plan.py).
    `misaligned`: x starts 4 bytes past a 16-byte boundary."""
    b, c, t, k, d = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    w = 1e-3 if large else 0.1
    params = (r(c, c, k) * w, r(c) * 0.1, r(c) * 0.3, r(c) * 0.3,
              r(c, c, k) * w, r(c) * 0.1, r(c) * 0.3, r(c) * 0.3)
    n_buf = max(1, -(-100_000_000 // (b * c * t * 4))) if timed else 1
    xs = [(r(b, c, t) * (100.0 if large else 1.0)).to(dtype) for _ in range(n_buf)]
    if misaligned:
        xs = [misalign(x) for x in xs]
    got = amp_cuda.amp_iter_cuda(xs[0], *params, k, d)
    want = amp_cuda.amp_iter_ref(xs[0].float(), *params, k, d).to(dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = AMP_F32_TOL if dtype == torch.float32 else BF16_TOL
    label = f"{case} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    check(torch.allclose(got.float(), want.float(), **tol),
          f"amp_iter disagrees at {label}: max abs err {err}")
    bnd, by, tc = amp_bounds(b, c, t, k, xs[0].element_size())
    row = dict(case=list(case), dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
               tile=amp_cuda.amp_tile(b, c, t, k, d), bound_ms=bnd, bound_by=by,
               tc_bound_ms=tc, large=large, misaligned=misaligned)
    old = None
    if prev is not None:
        before = prev["amp"](xs[0], *params, k, d)
        row["prev_err"] = (before.float() - got.float()).abs().max().item()

        def old(i=0):
            return prev["amp"](xs[i % n_buf], *params, k, d)
    if timed:
        timed_pair(row, lambda i=0: amp_cuda.amp_iter_cuda(xs[i % n_buf], *params, k, d), old,
                   20)
        row["unfused_ms"] = cuda_ms(lambda i=0: amp_unfused(xs[i % n_buf], *params, k, d), 20)
        row["plain_ms"] = cuda_ms(
            lambda i=0: amp_cuda.amp_iter_ref(xs[i % n_buf], *params, k, d), 10)
    return row


def check_mma_corner(shape, dtype, seed: int, large: bool, misaligned: bool) -> dict:
    """The mma kernel against its plain version and the direct kernel at a
    large-argument or misaligned input (untimed), at the same tolerances."""
    xs, alpha, beta = snake_inputs(shape, dtype, seed, large=large, n_buf=1)
    x = misalign(xs[0]) if misaligned else xs[0]
    got = snake_cuda.snake_alias_mma_cuda(x, alpha, beta)
    want = snake_alias_fused_cm(x.float(), alpha, beta).to(dtype)
    direct = snake_cuda.snake_alias_cuda(x, alpha, beta)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    label = f"{shape} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    errs = {"plain": (got.float() - want.float()).abs().max().item(),
            "direct": (got.float() - direct.float()).abs().max().item()}
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake mma kernel disagrees at {label}: max abs err {errs['plain']}")
    check(torch.allclose(got.float(), direct.float(), **tol),
          f"snake mma kernel against direct at {label}: max abs diff {errs['direct']}")
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), large=large,
                misaligned=misaligned, errs=errs,
                max_abs_x_alpha=(x.float().abs().amax(dim=(0, 2)) * alpha.exp()).max().item())


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
    row = dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."),
               max_abs_err=max(errs.values()), errs=errs)
    row["kernel_ms"] = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_cuda(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    row["plain_ms"] = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_plain(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    n = b * c * t
    # x and dy read once, dx written once; alpha, beta read, dalpha, dbeta written
    row["bound_ms"], row["bound_by"] = bound_ms(3 * n * xs[0].element_size() + 4 * c * 4,
                                                n * SNAKE_BWD_OPS_PER_ELEM)
    return row


def check_corner(shape, dtype, seed: int, large: bool = False, misaligned: bool = False) -> dict:
    """The forward and the backward kernel against their plain versions at one
    corner of the work plan (untimed): the same tolerances as the main
    shapes; dalpha/dbeta bitwise equal across two calls."""
    xs, alpha, beta = snake_inputs(shape, dtype, seed, large=large, n_buf=1)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x, dy = xs[0], torch.randn(shape, device="cuda", generator=g).to(dtype)
    if misaligned:
        x, dy = misalign(x), misalign(dy)
    f32 = dtype == torch.float32
    tol, btol = (F32_TOL, BWD_F32_TOL) if f32 else (BF16_TOL, BF16_TOL)
    got = snake_cuda.snake_alias_cuda(x, alpha, beta)
    want = snake_alias_fused_cm(x.float(), alpha, beta).to(dtype)
    got_b = snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    again = snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    want_b = snake_cuda.snake_alias_bwd_plain(x.float(), alpha, beta, dy.float())
    want_b = (want_b[0].to(dtype), want_b[1], want_b[2])
    torch.cuda.synchronize()
    label = f"{shape} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    errs = {"y": (got.float() - want.float()).abs().max().item()}
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake kernel disagrees at {label}: max abs err {errs['y']}")
    for name, a, w in zip(("dx", "dalpha", "dbeta"), got_b, want_b):
        errs[name] = (a.float() - w.float()).abs().max().item()
        check(torch.allclose(a.float(), w.float(), **btol),
              f"snake backward kernel disagrees on {name} at {label}: max abs err {errs[name]}")
    check(torch.equal(got_b[1], again[1]) and torch.equal(got_b[2], again[2]),
          f"dalpha/dbeta differ between two calls at {label}")
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), large=large,
                misaligned=misaligned, errs=errs,
                max_abs_x_alpha=(x.float().abs().amax(dim=(0, 2)) * alpha.exp()).max().item())


def per_call_sum(rows, stages, extra: tuple[str, ...] = ()) -> tuple[dict, str]:
    """Kernel, plain and bound ms (and any `extra` column) summed over the
    calls of `stages`, f32."""
    columns = {"ms": "kernel_ms", "plain_ms": "plain_ms", "bound_ms": "bound_ms"}
    columns |= {name: name for name in extra}
    total = dict.fromkeys(columns, 0.0)
    bound_by = set()
    for shape, calls in stages:
        r = next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == "float32")
        for name, column in columns.items():
            total[name] += calls * r[column]
        bound_by.add(r["bound_by"])
    return total, "/".join(sorted(bound_by))


def alt_kernel_phase(hp, stages, prev: dict | None) -> dict:
    """The strips, mma and fused-iteration kernels against their plain
    versions; per-chunk sums over the calls each takes on its path; with
    `prev`, the earlier mma and fused kernels timed in turns with the new
    ones at the chunk's shapes."""
    out = {}
    both = (torch.float32, torch.bfloat16)
    stage_list = [shape for shape, _ in stages]
    shapes = stage_list + list(ODD_SHAPES) + list(STRIPS_ODD_SHAPES)
    for variant in ("strips", "mma"):
        rows = [check_kernel(shape, dtype, seed=400 + i, variant=variant,
                             prev=prev if variant == "mma" and shape in stage_list else None)
                for i, shape in enumerate(shapes) for dtype in both]
        for r in rows:
            print(f"[kernel-{variant}] " + json.dumps(r), flush=True)
        taken = [(shape, calls) for shape, calls in stages
                 if variant == "mma" or snake_cuda.use_strips(shape[1], shape[2], shape[0])]
        extra = ("direct_ms",) + (("prev_ms",) if prev and variant == "mma" else ())
        total, by = per_call_sum(rows, taken, extra=extra)
        n_calls = sum(calls for _, calls in taken)
        print(f"[kernel-{variant}] per {CHUNK_FRAMES}-frame chunk, f32, the {n_calls} calls "
              f"the variant takes: {json.dumps(total)}", flush=True)
        out |= {variant: total, f"{variant}_rows": rows, f"{variant}_bound_by": by,
                f"{variant}_calls": n_calls}
    corners = [(shape, True, False) for shape in LARGE_ARG_SHAPES]
    corners += [((2, 16, 1024), False, True), ((16, 160, 125), False, True)]
    for i, (shape, large, misaligned) in enumerate(corners):
        for dtype in both:
            r = check_mma_corner(shape, dtype, seed=450 + i, large=large, misaligned=misaligned)
            print("[kernel-mma-corner] " + json.dumps(r), flush=True)

    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on for the plain convolutions")
    cases = [(b, c, t, k, d) for (b, c, t), _ in stages if amp_cuda.use_fused_iter(c, t, b)
             for k, dil in zip(hp.gen.resblock_kernel_sizes, hp.gen.resblock_dilation_sizes)
             for d in dil]
    rows = []
    for i, case in enumerate(cases):
        rows.append(check_amp(case, torch.float32, seed=500 + i, timed=True, prev=prev))
        rows.append(check_amp(case, torch.bfloat16, seed=500 + i, timed=False))
    for i, case in enumerate(AMP_ODD_CASES):
        rows += [check_amp(case, dtype, seed=600 + i, timed=False) for dtype in both]
    for i, case in enumerate(AMP_CORNER_CASES):
        for dtype in both:
            rows.append(check_amp(case, dtype, seed=650 + i, timed=False, large=True))
            rows.append(check_amp(case, dtype, seed=660 + i, timed=False, misaligned=True))
    for r in rows:
        print("[kernel-amp] " + json.dumps(r), flush=True)
    timed = [r for r in rows if "kernel_ms" in r]
    columns = (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
               ("tc_bound_ms", "tc_bound_ms"), ("unfused_ms", "unfused_ms"))
    columns += (("prev_ms", "prev_ms"),) if prev else ()
    total = {name: sum(r[column] for r in timed) for name, column in columns}
    print(f"[kernel-amp] per {CHUNK_FRAMES}-frame chunk, f32, {len(timed)} calls: "
          f"{json.dumps(total)}", flush=True)
    if prev:
        print(f"[compare-prev] f32, CUDA events, cold L2, same inputs, in turns: mma "
              f"{out['mma']['ms']:.4f} ms per chunk (earlier {out['mma']['prev_ms']:.4f}, "
              f"direct {out['mma']['direct_ms']:.4f}); amp_iter {total['ms']:.4f} ms per chunk "
              f"(earlier {total['prev_ms']:.4f}, unfused {total['unfused_ms']:.4f})",
              flush=True)
    out |= {"amp": total, "amp_rows": rows, "amp_calls": len(timed),
            "amp_bound_by": "/".join(sorted({r["bound_by"] for r in timed}))}
    return out


def alt_config_phase(hp, model, cpu_model, short_req, cpu_audio) -> dict:
    """`svc_infer` with the default model's weights in each alternative
    configuration: launches per chunk, waveforms against the default
    configuration's, wall and device time beside the default's; the fused
    configuration also against the CPU on `short_req` (out_chunk=200)."""
    hop, sr = hp.data.hop_length, hp.data.sampling_rate
    reqs = [features(hp, frames, seed=10 + i) for i, frames in enumerate(ALT_REQUEST_FRAMES)]
    n_chunks = sum(len(pipeline._chunk_plan(f, 1000, 10)) for f in ALT_REQUEST_FRAMES)
    audio_s = sum(ALT_REQUEST_FRAMES) * hop / sr
    run = dict(hp=hp, device="cuda")

    def drive(m, label):
        pipeline.svc_infer(m, DummyRetrieval(), *reqs[1], **run)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        audios, walls = [], []
        for frames, req in zip(ALT_REQUEST_FRAMES, reqs):
            t0 = time.perf_counter()
            audio = pipeline.svc_infer(m, DummyRetrieval(), *req, **run)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rms = float(np.sqrt(np.mean(np.square(audio))))
            check(audio.shape == (frames * hop,), f"{label}: output shape {audio.shape}")
            check(bool(np.isfinite(audio).all()), f"{label}: non-finite samples")
            check(rms > 1e-3, f"{label}: silent output (rms {rms})")
            audios.append(audio)
        counts = read_counts()
        prof = profile(lambda: pipeline.svc_infer(m, DummyRetrieval(), *reqs[1], **run))
        return dict(audios=audios, walls=walls, counts=counts, device_ms=prof["busy_ms"],
                    kinds=prof["kinds"])

    def report(label, r):
        wall = sum(r["walls"])
        print(f"[requests-{label}] {n_chunks} chunks ({audio_s:.2f} s audio): wall ms "
              f"{[round(w, 2) for w in r['walls']]}, realtime x{audio_s / (wall / 1e3):.2f}, "
              f"device {r['device_ms']:.2f} ms per chunk (200-frame request, profiler on), "
              f"launches {json.dumps(r['counts'])}, device ms by kind "
              + json.dumps({k: round(v, 3) for k, v in r["kinds"].items() if v}), flush=True)

    base = drive(model, "default")
    check(base["counts"] == dict(direct=91 * n_chunks, bwd=0, strips=0, mma=0, amp=0),
          f"default configuration launches {base['counts']}")
    report("default", base)
    out = {"default": base}
    for label, kwargs in ALT_CONFIGS.items():
        m = pipeline.build_infer_model(hp, device="cuda", seed=0, **kwargs)
        m.load_state_dict(model.state_dict())
        r = drive(m, label)
        want = dict(direct=0, bwd=0, strips=0, mma=0, amp=0) | {
            k: v * n_chunks for k, v in ALT_LAUNCHES_PER_CHUNK[label].items()}
        check(r["counts"] == want, f"{label} configuration launches {r['counts']}, "
                                   f"expected {want}")
        r["err"] = max(float(np.abs(a - b).max()) for a, b in zip(r["audios"], base["audios"]))
        check(r["err"] <= CARD_VS_CPU_ATOL,
              f"{label} configuration vs default on the card: max abs err {r['err']}")
        report(label, r)
        print(f"[requests-{label}] vs the default configuration on the card: max abs err "
              f"{r['err']:.3e} (tolerance {CARD_VS_CPU_ATOL})", flush=True)
        if label == "fused":
            short = dict(hp=hp, out_chunk=200)
            card = pipeline.svc_infer(m, DummyRetrieval(), *short_req, device="cuda", **short)
            cpu_m = pipeline.build_infer_model(hp, device="cpu", seed=0, **kwargs)
            cpu_m.load_state_dict(cpu_model.state_dict())
            cpu = pipeline.svc_infer(cpu_m, DummyRetrieval(), *short_req, device="cpu", **short)
            err = float(np.abs(card - cpu).max())
            same = float(np.abs(cpu - cpu_audio).max())
            print(f"[requests-fused] card vs CPU (amp_iter_ref), 200 frames: max abs err "
                  f"{err:.3e} (tolerance {CARD_VS_CPU_ATOL}); the CPU's fused and default "
                  f"configurations differ by {same:.3e}", flush=True)
            check(err <= CARD_VS_CPU_ATOL, f"fused configuration card vs CPU: {err}")
            del cpu_m
        del r["audios"], m
        out[label] = r
    del base["audios"]
    return out


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
    ("snake_strips", ("snake_alias_strips_kernel",)),
    ("snake_mma", ("snake_alias_mma_kernel",)),
    ("amp_iter", ("amp_iter_kernel",)),
    ("conv", ("cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "conv")),
    ("matmul", ("gemm", "cutlass", "sm90_")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
)


def profile(fn) -> dict:
    """torch.profiler over fn(): the table by device time, wall ms, device
    busy ms (kernels, copies; no user-annotation ranges), device ms and
    kernel count by kernel kind."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS} | {"other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kind = next((k for k, keys in KERNEL_KINDS if any(key in e.name for key in keys)),
                    "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
        counts[kind] += 1
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                      max_name_column_width=48)
    return dict(table=table, wall_ms=wall_us / 1e3, busy_ms=sum(kinds.values()),
                kinds=kinds, counts=counts)


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

    resolve_device("cuda")  # TF32 off: the plain versions' convolutions run in float32
    t0 = time.perf_counter()
    sources = snake_cuda.all_sources()
    compare = all(p.exists() for p in (*PREV_SOURCES, PREV_DIR / "snake_alias.cuh"))
    libs = snake_cuda.build(*sources, *(PREV_SOURCES if compare else ()))
    for load in (snake_cuda._library, snake_cuda._library_bwd, snake_cuda._library_strips,
                 snake_cuda._library_mma, amp_cuda._library):
        load()
    prev = load_prev()
    check(len(sources) == 5, f"{len(sources)} kernel sources, expected 5")
    print(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s"
          + (f" (with the earlier mma and amp_iter from {PREV_DIR.name}/)" if prev else
             "; no build/prev_kernels/: no comparison with earlier kernels"), flush=True)

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

    # the corners of the work plan, and large arguments, forward and backward
    corners = [(shape, False, False) for shape in PLAN_ODD_SHAPES + BWD_ODD_SHAPES]
    corners += [((2, 16, 1024), False, True), ((16, 160, 125), False, True)]
    corners += [(shape, True, False) for shape in LARGE_ARG_SHAPES]
    for i, (shape, large, misaligned) in enumerate(corners):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_corner(shape, dtype, seed=700 + i, large=large, misaligned=misaligned)
            print("[kernel-corner] " + json.dumps(r), flush=True)
    print(f"[kernel-corner] {2 * len(corners)} cases within the tolerances", flush=True)

    alt = alt_kernel_phase(hp, stages, prev)

    # requests at full base width on the card
    model = pipeline.build_infer_model(hp, device="cuda", seed=0)
    run = dict(hp=hp, device="cuda")
    reqs = [features(hp, frames, seed=i) for i, frames in enumerate(REQUEST_FRAMES)]
    pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
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
    counts_default = counts = read_counts()
    launches, infer_bwd = counts["direct"], counts["bwd"]
    check(launches == 91 * total_chunks,
          f"{launches} snake launches for {total_chunks} chunks, expected 91 per chunk")
    check(infer_bwd == 0, f"{infer_bwd} backward snake launches during inference")
    check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
          f"the default configuration launched an alternative kernel: {counts}")
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

    # the three alternative configurations of the same weights
    alt_runs = alt_config_phase(hp, model, cpu_model, reqs[-1], cpu)
    del model, cpu_model

    # training steps at full base width on the card
    reset_counts()
    tr = train_phase(hp)
    counts = read_counts()
    train_fwd, train_bwd = counts["direct"], counts["bwd"]
    n_steps = TIMED_STEPS + 2  # warm-up, timed, profiled
    check(train_fwd == 91 * n_steps and train_bwd == 91 * n_steps,
          f"{train_fwd} forward / {train_bwd} backward snake launches in {n_steps} steps")
    check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
          f"the training step launched an alternative kernel: {counts}")
    ms_step = float(np.mean(tr["step_ms"]))
    utt_s = hp.train.batch_size / (ms_step / 1e3)
    print(f"[train] {TIMED_STEPS} timed steps, batch {hp.train.batch_size} x {TRAIN_FRAMES} "
          f"frames: {ms_step:.2f} ms per step (steps {[round(t, 2) for t in tr['step_ms']]}), "
          f"{utt_s:.2f} utterances/s, peak device memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; snake launches fwd {train_fwd} bwd {train_bwd} "
          f"in {n_steps} steps", flush=True)
    prof = tr["profile"]
    print(prof["table"], flush=True)
    check(prof["counts"]["snake_fwd"] == 91 and prof["counts"]["snake_bwd"] == 91,
          f"profiled step: {prof['counts']['snake_fwd']} forward and "
          f"{prof['counts']['snake_bwd']} backward snake kernels, expected 91 each")
    print(f"[train-profile] one step: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
          f"profiler on; device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
          + "; kernels by kind " + json.dumps(prof["counts"]), flush=True)

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
    chunk = f"one {CHUNK_FRAMES}-frame chunk at base width, float32"
    fused_run = alt_runs["fused"]
    kernels.append({
        "name": "amp_iter", "route": "cuda", "source": SOURCE_AMP, "replaces": REPLACES_AMP,
        "launches": fused_run["counts"]["amp"],
        "max_abs_err": max(r["max_abs_err"] for r in alt["amp_rows"]
                           if r["dtype"] == "float32"),
        "ms": alt["amp"]["ms"], "plain_ms": alt["amp"]["plain_ms"],
        "bound_ms": alt["amp"]["bound_ms"], "bound_by": alt["amp_bound_by"],
        "library_ms": None, "unfused_ms": alt["amp"]["unfused_ms"],
        "tc_bound_ms": alt["amp"]["tc_bound_ms"], "prev_ms": alt["amp"].get("prev_ms"),
        "per": f"{chunk}, {alt['amp_calls']} calls (amp_fused_iter=True)",
        "launches_by_path": {"svc_infer": counts_default["amp"],
                             "svc_infer_fused": fused_run["counts"]["amp"],
                             "train_step": counts["amp"]},
    })
    for variant, source, replaces in (("strips", SOURCE_STRIPS, REPLACES_STRIPS),
                                      ("mma", SOURCE_MMA, REPLACES_MMA)):
        run, total = alt_runs[variant], alt[variant]
        kernels.append({
            "name": f"snake_alias_{variant}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["counts"][variant],
            "max_abs_err": max(r["max_abs_err"] for r in alt[f"{variant}_rows"]
                               if r["dtype"] == "float32"),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": alt[f"{variant}_bound_by"], "library_ms": None,
            "direct_ms": total["direct_ms"], "prev_ms": total.get("prev_ms"),
            "per": f"{chunk}, {alt[f'{variant}_calls']} calls "
                   f"(snake_variant=\"{variant}\")",
            "launches_by_path": {"svc_infer": counts_default[variant],
                                 f"svc_infer_{variant}": run["counts"][variant],
                                 "train_step": counts[variant]},
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
