"""Wrappers of the fused anti-aliased snake CUDA kernels (csrc/snake_alias.cu,
csrc/snake_alias_bwd.cu, csrc/snake_alias_strips.cu, csrc/snake_alias_mma.cu)
and their autograd Function.

Replace the TPU kernels whisper_vits_svc_tpu/ops/pallas_snake.py::
snake_alias_cm_pallas (forward; its `strips=True` launch and its `mxu=True`
form too) and ::snake_alias_cm_pallas_bwd (backward). Each source is built
and bound by ops/cuda_build.py. The snake kernels are bound by HBM bytes
(see the notes in the sources); `fir_taps` gives their polyphase FIR taps,
which csrc/amp_iter.cu reads too.

The direct forward and the backward kernels share one work plan,
`snake_plan`: a warp makes SEG_LEN (248) consecutive outputs of one (b, c)
row, a lane a run of RUN (8) of them from registers; segments start 16-byte
aligned in memory, so a row has `n_seg` of them, the first starting up to
7 samples before the row; WARPS (8) warps a block, so a block may hold
several short rows. The backward is one launch: its per-channel dalpha and
dbeta are summed by the last warp of each channel, found with an integer
ticket per channel that the kernel sets back to 0 (`cuda_build.tickets`);
its edge clamp sums take their coefficients from `clamp_taps`.

`snake_alias` takes the plain PyTorch version (nn/snake.py) only for a CPU
tensor; for a CUDA tensor it launches the kernels or raises. When a gradient
is wanted it goes through `SnakeAliasFunction`, which saves only x, alpha
and beta (as the JAX custom VJP does) and runs the backward kernel; without
one (e.g. under torch.inference_mode) it launches the forward alone.
`variant` chooses the forward kernel: "direct" (the plan above), "strips"
(narrow, long shapes cut into segments that fill the card once; bitwise
equal to "direct") or "mma" (the direct kernel's plan and phases, the down
FIRs as 3xTF32 products on the tensor cores). The two alternatives are
forward only, as in the JAX package. Without a gradient the direct
forward goes through the operator `svc::snake_alias` (`snake_alias_op`),
which torch.export keeps as one node: the serving artifact
(infer/serving.py) runs the kernel too. `launches`, `launches_bwd`,
`launches_strips` and `launches_mma` count kernel launches (`counts`,
`add_counts`; utils/counters.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..nn.snake import _polyphase_taps, snake_alias_fused_cm
from ..utils import counters
from .cuda_build import CSRC, load_library, param, tickets

SOURCE = CSRC / "snake_alias.cu"
SOURCE_BWD = CSRC / "snake_alias_bwd.cu"
SOURCE_STRIPS = CSRC / "snake_alias_strips.cu"
SOURCE_MMA = CSRC / "snake_alias_mma.cu"

VARIANTS = ("direct", "strips", "mma")
# "strips" takes narrow, long shapes (the generator's last two stages at base
# width); the others stay with the direct kernel
STRIPS_MAX_C = 32
STRIPS_MIN_BT = 100_000
# blocks an H100 holds at once: 132 SMs x 8 resident 256-thread blocks
H100_BLOCK_SLOTS = 132 * 8
# the forward and backward kernels' work plan (csrc/snake_alias.cuh)
RUN = 8                  # consecutive outputs a lane
SEG_LEN = 31 * RUN       # outputs a warp segment: lane 31 computes lane 30's phases
WARPS = 8                # warps a block
STRIPS_MIN_SEG = SEG_LEN
STRIPS_MAX_SEG = 2 * WARPS * SEG_LEN  # two rounds of a block's warp segments

launches = 0
launches_bwd = 0
launches_strips = 0
launches_mma = 0
counts, add_counts = counters.declare(__name__, "launches", "launches_bwd", "launches_strips",
                                      "launches_mma")


_PTR, _INT, _TAPS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load_library(SOURCE, "snake_alias_forward",
                        [_PTR] * 4 + [_TAPS] + [_INT] * 6 + [_PTR], "snake_alias_error_string")


@lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    return load_library(SOURCE_BWD, "snake_alias_backward",
                        [_PTR] * 10 + [_TAPS] + [_INT] * 6 + [_PTR],
                        "snake_alias_backward_error_string")


@lru_cache(maxsize=None)
def _library_strips() -> ctypes.CDLL:
    return load_library(SOURCE_STRIPS, "snake_alias_strips_forward",
                        [_PTR] * 4 + [_TAPS] + [_INT] * 6 + [_PTR],
                        "snake_alias_strips_error_string")


@lru_cache(maxsize=None)
def _library_mma() -> ctypes.CDLL:
    return load_library(SOURCE_MMA, "snake_alias_mma_forward",
                        [_PTR] * 5 + [_TAPS] + [_INT] * 7 + [_PTR],
                        "snake_alias_mma_error_string")


@lru_cache(maxsize=None)
def fir_taps():
    """The up and down FIRs' polyphase taps as the kernels read them: 24
    floats, ae, ao, de, do (6 each) of the k=12 geometry."""
    ae, ao, oe, oo, de, do_, doe, doo = _polyphase_taps(12, 12)
    assert (oe, oo, doe, doo) == (-3, -2, -2, -3), "kernel assumes the k=12 geometry"
    assert len(ae) == len(ao) == len(de) == len(do_) == 6
    return (ctypes.c_float * 24)(*np.concatenate([ae, ao, de, do_]).tolist())


@lru_cache(maxsize=None)
def clamp_taps() -> dict[str, np.ndarray]:
    """The backward's edge terms as weights of values next to the edges, all
    float32 [3]. hd[k] weighs dy[k] in the clamp sum onto s_e[0] (the down-FIR
    adjoints dE[q] + dO[q] at q = -3..-1), td[k] weighs dy[T-3+k] in the sum
    onto s_o[T-1] (q = T..T+2); hxe/hxo[k] weigh du_e/du_o[k] in the
    edge-pad adjoint onto dx[0] (the up-FIR adjoint dxp[q] at q = -3..-1),
    txe/txo[k] weigh du_e/du_o[T-3+k] in the one onto dx[T-1]. dy and du are
    zero outside [0, T), so nothing else reaches these sums."""
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    w = {name: np.zeros(3, np.float64) for name in ("hd", "td", "hxe", "hxo", "txe", "txo")}

    def add(name, k, v):
        if 0 <= k <= 2:
            w[name][k] += v

    for m in range(6):
        for q in (-3, -2, -1):
            # dE[q] = sum de[m] dy[q+2-m], dO[q] = sum do[m] dy[q+3-m];
            # dxp[q] = sum ae[m] du_e[q+3-m] + ao[m] du_o[q+2-m]
            add("hd", q + 2 - m, de[m])
            add("hd", q + 3 - m, do_[m])
            add("hxe", q + 3 - m, ae[m])
            add("hxo", q + 2 - m, ao[m])
        for d in (0, 1, 2):  # q = T + d; position T-3+k has k = position - T + 3
            add("td", d + 5 - m, de[m])
            add("td", d + 6 - m, do_[m])
            add("txe", d + 6 - m, ae[m])
            add("txo", d + 5 - m, ao[m])
    return {k: v.astype(np.float32) for k, v in w.items()}


@lru_cache(maxsize=None)
def _taps_bwd():
    """The backward kernel's 42 floats: ae, ao, de, do, hd, td, hxe, hxo, txe, txo."""
    edge = clamp_taps()
    values = np.concatenate([np.asarray(fir_taps(), np.float32)]
                            + [edge[k] for k in ("hd", "td", "hxe", "hxo", "txe", "txo")])
    return (ctypes.c_float * 42)(*values.tolist())


@dataclass(frozen=True)
class SnakePlan:
    """The work plan of the forward and backward kernels for rows =
    B * C rows of length t: n_seg warp segments per row, vec elements per
    16-byte access."""
    rows: int
    t: int
    vec: int
    n_seg: int

    @property
    def warps(self) -> int:
        return self.rows * self.n_seg

    def segment(self, warp: int) -> tuple[int, int, int, int]:
        """(row, s, lo, hi): warp `warp` runs the segment whose lane 0 starts
        at output s of row `row`, and writes the outputs in [lo, hi) (empty
        when lo >= hi). For segment k of the row, s is the position at or
        before k * SEG_LEN whose address is 16-byte aligned when the
        tensor's start is."""
        row, k = divmod(warp, self.n_seg)
        s = k * SEG_LEN - (row * self.t) % self.vec
        return row, s, max(s, 0), min(s + SEG_LEN, self.t)


def snake_plan(b: int, c: int, t: int, itemsize: int) -> SnakePlan:
    """The plan for [b, c, t] of `itemsize`-byte elements (4 or 2): every
    row gets the same n_seg = ceil((t + vec - 1) / SEG_LEN) segments, enough
    for the row and its first segment's aligned start."""
    vec = 16 // itemsize
    return SnakePlan(rows=b * c, t=t, vec=vec, n_seg=-(-(t + vec - 1) // SEG_LEN))


def _check_input(name: str, x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous [B, C, T] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    b, c, t = x.shape
    if not (0 < b <= 65535 and 0 < c <= 65535 and 0 < t < 2**31 - 2048):
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"alpha/beta must be [{c}], got {tuple(alpha.shape)}, "
                         f"{tuple(beta.shape)}")


def _launch_forward(name: str, library, x: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor, before_taps: tuple = (), after_shape: tuple = ()):
    """Check the inputs, then launch `<name>_forward(x, out, alpha, beta,
    *before_taps, taps, is_bf16, B, C, T, *after_shape, stream)` of the
    library that `library()` loads, on the current stream; raises on a
    refused launch. Returns the output."""
    _check_input(f"{name}_cuda", x, alpha, beta)
    lib = library()
    b, c, t = x.shape
    alpha, beta = param(alpha, x.device), param(beta, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_forward")(
            x.data_ptr(), out.data_ptr(), alpha.data_ptr(), beta.data_ptr(), *before_taps,
            fir_taps(), int(x.dtype == torch.bfloat16), b, c, t, *after_shape, stream)
    if err:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        extra = f" with {after_shape}" if after_shape else ""
        raise RuntimeError(f"{name} kernel launch failed{extra}: {message}")
    return out


def snake_alias_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on x [B, C, T] (CUDA, contiguous, float32
    or bfloat16; math in float32), alpha/beta [C]. Returns a new tensor of
    x's dtype. Launches on the current stream; does not synchronize."""
    global launches
    _check_input("snake_alias_cuda", x, alpha, beta)
    plan = snake_plan(*x.shape, x.element_size())
    out = _launch_forward("snake_alias", _library, x, alpha, beta,
                          after_shape=(plan.n_seg, SEG_LEN))
    launches += 1
    return out


def use_strips(c: int, t: int, b: int = 1) -> bool:
    """The shapes variant="strips" takes: narrow and long."""
    return c <= STRIPS_MAX_C and b * t >= STRIPS_MIN_BT


def strip_fold(c: int, t: int, b: int = 1, slots: int = H100_BLOCK_SLOTS) -> int:
    """Segments per [T] row for the strips launch: as many as fill the
    card's `slots` resident blocks once with b * c * fold blocks, but no
    segment shorter than one warp segment (STRIPS_MIN_SEG) or longer than
    two rounds of the block's warps (STRIPS_MAX_SEG): a block's warps walk
    its segment in warp segments, and a block that walks far leaves the card
    to its slowest blocks. Segment s of a row is [s * seg, min((s + 1) * seg, t)) with
    seg = ceil(t / fold): the segments are non-empty and cover the row
    exactly once."""
    want = max(1, slots // (b * c))
    seg = min(max(-(-t // want), STRIPS_MIN_SEG), STRIPS_MAX_SEG, t)
    return -(-t // seg)


def snake_alias_strips_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                            fold: int | None = None) -> torch.Tensor:
    """Launch the strips kernel on x [B, C, T] (any shape `snake_alias_cuda`
    takes), each row in `fold` segments (default: `strip_fold` for this
    card). Bitwise equal to `snake_alias_cuda`. Launches on the current
    stream; does not synchronize."""
    global launches_strips
    _check_input("snake_alias_strips_cuda", x, alpha, beta)
    b, c, t = x.shape
    if fold is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        fold = strip_fold(c, t, b, slots=8 * sms)
    out = _launch_forward("snake_alias_strips", _library_strips, x, alpha, beta,
                          after_shape=(fold, -(-t // fold)))
    launches_strips += 1
    return out


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 number (10 mantissa bits, ties away from
    zero, as `cvt.rna.tf32.f32` rounds), held in float32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = hi + lo up to 2^-22 |a|, both TF32 numbers: the operands of a
    3xTF32 product (lo x hi + hi x lo + hi x hi)."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


@lru_cache(maxsize=None)
def down_fir_matrix() -> np.ndarray:
    """The banded down-FIR matrix of the mma kernel, from the 12 down taps.
    B_dn [48, 16]: a row of 16 outputs from q reads E[q - 3 + kk] (rows
    kk < 24, B[kk][j] = de[kk - j - 1]) and O[q - 3 + kk] (rows 24 + kk,
    B[24 + kk][j] = do[kk - j])."""
    _, _, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    fir_taps()  # asserts the geometry the offsets above assume
    b_dn = np.zeros((48, 16), np.float32)
    for j in range(16):
        for m in range(6):
            b_dn[j + 1 + m, j] = de[m]
            b_dn[24 + j + m, j] = do_[m]
    return b_dn


@lru_cache(maxsize=None)
def _fir_device(device: torch.device) -> torch.Tensor:
    """[B_dn hi, B_dn lo] flattened, on `device`."""
    hi, lo = tf32_split(torch.from_numpy(down_fir_matrix()))
    return torch.cat([hi.flatten(), lo.flatten()]).to(device)


# blocks of the mma kernel per SM (its __launch_bounds__; 2 or 4, and larger
# grids, measured slower: PERF.md): its warps walk their segments at a
# stride of the grid's warps, each loading the next run while computing
MMA_BLOCKS_PER_SM = 3


def snake_alias_mma_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the tensor-core kernel on x [B, C, T] (any shape
    `snake_alias_cuda` takes): the direct kernel's plan and phases, the down
    FIR as 3xTF32 products (float32 accuracy). Launches on the current
    stream; does not synchronize."""
    global launches_mma
    _check_input("snake_alias_mma_cuda", x, alpha, beta)
    plan = snake_plan(*x.shape, x.element_size())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = _launch_forward("snake_alias_mma", _library_mma, x, alpha, beta,
                          before_taps=(_fir_device(x.device).data_ptr(),),
                          after_shape=(plan.n_seg, SEG_LEN, MMA_BLOCKS_PER_SM * sms))
    launches_mma += 1
    return out


def snake_alias_bwd_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dx in x's dtype, dalpha and dbeta in
    float32 [C]) for the cotangent dy of snake_alias_cuda(x, alpha, beta).
    One launch; dalpha/dbeta are reduced without float atomics (bitwise
    reproducible). Launches on the current stream; does not synchronize."""
    global launches_bwd
    _check_input("snake_alias_bwd_cuda", x, alpha, beta)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} on {dy.device} vs "
                         f"{tuple(x.shape)} on {x.device}")
    b, c, t = x.shape
    dy = dy.to(x.dtype).contiguous()
    alpha, beta = param(alpha, x.device), param(beta, x.device)
    lib = _library_bwd()
    plan = snake_plan(b, c, t, x.element_size())
    dx = torch.empty_like(x)
    parts = torch.empty((2, plan.warps), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ticket = tickets(x.device, c, stream)
        err = lib.snake_alias_backward(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), ticket.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            grads[0].data_ptr(), grads[1].data_ptr(), _taps_bwd(),
            int(x.dtype == torch.bfloat16), b, c, t, plan.n_seg, SEG_LEN, stream)
    if err:
        raise RuntimeError(f"snake_alias backward kernel launch failed: "
                           f"{lib.snake_alias_backward_error_string(err).decode()}")
    launches_bwd += 1
    return dx, grads[0], grads[1]


def snake_alias_bwd_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                          dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: torch.autograd.grad through snake_alias_fused_cm."""
    with torch.enable_grad():
        x, alpha, beta = (t.detach().requires_grad_(True) for t in (x, alpha, beta))
        y = snake_alias_fused_cm(x, alpha, beta)
        return torch.autograd.grad(y, (x, alpha, beta), dy)


class SnakeAliasFunction(torch.autograd.Function):
    """SnakeAlias through the kernels: the forward kernel, and the backward
    kernel for (dx, dalpha, dbeta). Saves x, alpha and beta only; the
    T-sized phases are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return snake_alias_cuda(x, alpha, beta)

    @staticmethod
    def backward(ctx, dy):
        x, alpha, beta = ctx.saved_tensors
        dx, dalpha, dbeta = snake_alias_bwd_cuda(x, alpha, beta, dy.contiguous())
        return dx, dalpha.to(alpha.dtype), dbeta.to(beta.dtype)


def _wants_grad(variant: str, x: torch.Tensor, alpha: torch.Tensor,
                beta: torch.Tensor) -> bool:
    """Whether autograd records a graph for this call; refuses an unknown
    variant, and a forward-only one where it does."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    grad = torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                        or beta.requires_grad)
    if grad and variant != "direct":
        raise RuntimeError(f'snake_alias variant "{variant}" is forward only; use '
                           f'"direct" where a gradient is wanted')
    return grad


@torch.library.custom_op("svc::snake_alias", mutates_args=())
def snake_alias_op(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The direct forward kernel as the operator `torch.ops.svc.snake_alias`
    (one launch of `snake_alias_cuda`), so that torch.export records it as
    one node of a graph where it cannot trace the ctypes call: a serving
    artifact keeps the kernel, and finds this operator by name once this
    module is imported before torch.export.load."""
    return snake_alias_cuda(x, alpha, beta)


@snake_alias_op.register_fake
def _snake_alias_fake(x, alpha, beta):
    return torch.empty_like(x)


def snake_alias_kernel(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                       variant: str = "direct") -> torch.Tensor:
    """The kernel route: through SnakeAliasFunction when autograd records a
    graph for any input (variant "direct" only: the others have no
    backward), else one forward launch of the variant's kernel, the direct
    one through `snake_alias_op`. "strips" takes the shapes `use_strips`
    names and leaves the others to the direct kernel; "mma" takes every
    shape."""
    if _wants_grad(variant, x, alpha, beta):
        return SnakeAliasFunction.apply(x, alpha, beta)
    if variant == "mma":
        return snake_alias_mma_cuda(x, alpha, beta)
    if variant == "strips" and use_strips(x.shape[1], x.shape[2], x.shape[0]):
        return snake_alias_strips_cuda(x, alpha, beta)
    return snake_alias_op(x, alpha, beta)


def snake_alias(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                variant: str = "direct") -> torch.Tensor:
    """SnakeAlias with exact edges on [B, C, T]: the kernels for a CUDA
    tensor, the plain version (differentiated by autograd) for a CPU tensor.
    Every variant computes the same function."""
    if x.device.type == "cpu":
        _wants_grad(variant, x, alpha, beta)
        return snake_alias_fused_cm(x, alpha, beta)
    return snake_alias_kernel(x, alpha, beta, variant)
