"""Anti-aliased snake activation: x2 Kaiser-sinc upsample -> SnakeBeta
`u + sin^2(e^alpha u) / (e^beta + 1e-9)` -> x2 lowpass downsample
(reference vits_decoder/alias/act.py:109-128), in polyphase form.

The chain is linear and time-invariant around the pointwise snake, so it
splits into two 6-tap up-phase FIRs (the even and odd samples of the x2
upsample), the snake on each phase, and two 6-tap down-phase FIRs. The taps
are derived numerically from the reference resamplers (`_polyphase_taps`).

`snake_alias_fused_cm` is the plain PyTorch version on [B, C, T]; the
`SnakeAlias` module runs it for a CPU tensor and the CUDA kernel
(ops/snake_cuda.py) for a CUDA tensor. `upsample1d`, `downsample1d` and
`snake_alias_fused` are the JAX package's [B, T, C] forms: the reference's
resamplers as depthwise convolutions, and the fused chain.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _kaiser_beta(A: float) -> float:
    if A > 50.0:
        return 0.1102 * (A - 8.7)
    if A >= 21.0:
        return 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    return 0.0


@lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, sum-normalized; [kernel_size] float32
    (reference vits_decoder/alias/filter.py:28-57, even and odd sizes)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    window = np.kaiser(kernel_size, _kaiser_beta(A))
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _sinc_kernel(x: torch.Tensor, ratio: int, kernel_size: int) -> torch.Tensor:
    """The Kaiser sinc lowpass as a depthwise kernel [C, 1, K] for [B, T, C] x."""
    filt = torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size))
    return filt.to(x)[None, None].expand(x.shape[-1], 1, -1)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """xN anti-aliased upsample on [B, T, C] (reference alias/resample.py:10-33):
    replicate-pad, transposed depthwise conv with the Kaiser sinc filter,
    scale by the ratio, trim the edges."""
    if kernel_size is None:
        kernel_size = int(6 * ratio // 2) * 2
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    xc = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xc, _sinc_kernel(x, ratio, kernel_size), stride=ratio,
                                   groups=x.shape[-1])
    return y[..., pad_left : y.shape[-1] - pad_right].transpose(1, 2)


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """xN anti-aliased downsample on [B, T, C] (reference alias/resample.py:36-49):
    replicate-pad, strided depthwise lowpass."""
    if kernel_size is None:
        kernel_size = int(6 * ratio // 2) * 2
    pad_left = kernel_size // 2 - int(kernel_size % 2 == 0)
    xc = F.pad(x.transpose(1, 2), (pad_left, kernel_size // 2), mode="replicate")
    return F.conv1d(xc, _sinc_kernel(x, ratio, kernel_size), stride=ratio,
                    groups=x.shape[-1]).transpose(1, 2)


def _np_upsample(x: np.ndarray, ratio: int = 2, k: int = 12) -> np.ndarray:
    """1-D replicate-pad, zero-stuff, filter and trim (alias/resample.py:10-33)."""
    f = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k).astype(np.float64)
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    xp = np.pad(x.astype(np.float64), (pad, pad), mode="edge")
    xd = np.zeros(len(xp) * ratio - (ratio - 1))
    xd[::ratio] = xp
    yf = ratio * np.convolve(xd, f, "full")
    return yf[pad_left : len(yf) - pad_right]


def _np_downsample(x: np.ndarray, ratio: int = 2, k: int = 12) -> np.ndarray:
    """1-D replicate-pad and strided lowpass (alias/resample.py:36-49)."""
    f = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k).astype(np.float64)
    pl = k // 2 - int(k % 2 == 0)
    pr = k // 2
    xp = np.pad(x.astype(np.float64), (pl, pr), mode="edge")
    n_out = (len(xp) - k) // ratio + 1
    return np.array([xp[t * ratio : t * ratio + k] @ f for t in range(n_out)])


@lru_cache(maxsize=None)
def _polyphase_taps(k_up: int = 12, k_down: int = 12):
    """(up_even, up_odd, up_off_e, up_off_o, down_even, down_odd, down_off_e,
    down_off_o), probed from the reference resamplers:

        up phase p: up[2t+p] = sum_m A_p[m] * x[t + up_off_p + m]
        down:       out[t]   = sum_m De[m] * s_e[t + down_off_e + m]
                             + sum_m Do[m] * s_o[t + down_off_o + m]
    """
    T = 64
    U = np.stack([_np_upsample(np.eye(T)[i], 2, k_up) for i in range(T)], axis=1)
    mid = T // 2

    def row_taps(row):
        nz = np.nonzero(np.abs(U[row]) > 1e-10)[0]
        return int(nz[0]), U[row, nz[0] : nz[-1] + 1]

    s0, a_even = row_taps(2 * mid)
    s1, a_odd = row_taps(2 * mid + 1)
    S = 2 * T
    D = np.stack([_np_downsample(np.eye(S)[i], 2, k_down) for i in range(S)], axis=1)
    trow = D[mid]
    nz = np.nonzero(np.abs(trow) > 1e-10)[0]
    evens = [int(p) for p in nz if p % 2 == 0]
    odds = [int(p) for p in nz if p % 2 == 1]
    return (
        a_even.astype(np.float32), a_odd.astype(np.float32), s0 - mid, s1 - mid,
        trow[evens].astype(np.float32), trow[odds].astype(np.float32),
        evens[0] // 2 - mid, (odds[0] - 1) // 2 - mid,
    )


def _dw_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Depthwise valid correlation along the last axis, as shifted adds."""
    n = x.shape[-1] - len(taps) + 1
    out = float(taps[0]) * x[..., :n]
    for m in range(1, len(taps)):
        out = out + float(taps[m]) * x[..., m : m + n]
    return out


def _dw_pad(x: torch.Tensor, taps: np.ndarray, pad: tuple[int, int]) -> torch.Tensor:
    """Zero-pad (a negative pad crops) then valid correlation."""
    lo, hi = pad
    if lo < 0:
        x, lo = x[..., -lo:], 0
    if hi < 0:
        x, hi = x[..., :hi], 0
    if lo or hi:
        x = F.pad(x, (lo, hi))
    return _dw_valid(x, taps)


def snake_alias_fused_cm(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         k_up: int = 12, k_down: int = 12,
                         exact_edges: bool = True) -> torch.Tensor:
    """Plain PyTorch SnakeAlias on [B, C, T]; alpha, beta [C] (log scale).

    exact_edges=True equals the reference chain including its
    edge-replicated boundaries: x is edge-padded for the up-phase FIRs, and
    the downsample input is clamped to s_e[0] before the start and s_o[T-1]
    past the end. exact_edges=False zero-pads inside each FIR instead; only
    the outermost ~6 samples differ.
    """
    ae, ao, oe, oo, de, do_, doe, doo = _polyphase_taps(k_up, k_down)
    a = torch.exp(alpha).to(x.dtype)[None, :, None]
    b = torch.exp(beta).to(x.dtype)[None, :, None]

    def snake(u):
        return u + (1.0 / (b + 1e-9)) * torch.square(torch.sin(u * a))

    if not exact_edges:
        s_e = snake(_dw_pad(x, ae, (-oe, oe + len(ae) - 1)))
        s_o = snake(_dw_pad(x, ao, (-oo, oo + len(ao) - 1)))
        return (_dw_pad(s_e, de, (-doe, doe + len(de) - 1))
                + _dw_pad(s_o, do_, (-doo, doo + len(do_) - 1)))

    t = x.shape[-1]
    m_lo = min(oe, oo)
    m_hi = max(oe + len(ae) - 1, oo + len(ao) - 1)
    xp = F.pad(x, (-m_lo, m_hi), mode="replicate")

    def up_phase(taps, off):
        start = off - m_lo
        return _dw_valid(xp[..., start : start + t + len(taps) - 1], taps)

    s_e = snake(up_phase(ae, oe))
    s_o = snake(up_phase(ao, oo))

    assert doe <= 0 and doo <= 0, (doe, doo)
    first, last = s_e[..., :1], s_o[..., -1:]

    def extend(s, pl, pr):
        return torch.cat([first.expand(*s.shape[:-1], pl), s,
                          last.expand(*s.shape[:-1], pr)], dim=-1)

    se_pad = extend(s_e, -doe, max(0, doe + len(de) - 1))
    so_pad = extend(s_o, -doo, max(0, doo + len(do_) - 1))
    return _dw_valid(se_pad, de) + _dw_valid(so_pad, do_)


def snake_alias_fused(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                      k_up: int = 12, k_down: int = 12,
                      exact_edges: bool = True) -> torch.Tensor:
    """`snake_alias_fused_cm` on [B, T, C]: with exact edges equal to
    downsample1d(SnakeBeta(upsample1d(x)))."""
    return snake_alias_fused_cm(x.transpose(1, 2), alpha, beta, k_up, k_down,
                                exact_edges).transpose(1, 2)


class SnakeBeta(nn.Module):
    """Per-channel log-scale alpha/beta of the reference SnakeBeta
    (act.py:36-92, alpha_logscale=True), held under `<name>.act`."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class SnakeAlias(nn.Module):
    """x2 up -> SnakeBeta -> x2 down on [B, C, T].

    With exact edges a CPU tensor takes the plain version and a CUDA tensor
    launches the kernel (ops/snake_cuda.py), at every shape. `variant` names
    the forward kernel: "direct", "strips" or "mma" (the last two forward
    only). exact_edges=False (the JAX package's fast_edges) runs the plain
    zero-padded chain on any device, as the JAX package runs its jnp chain
    there; no kernel has those edges."""

    def __init__(self, channels: int, variant: str = "direct", exact_edges: bool = True):
        super().__init__()
        self.variant = variant
        self.exact_edges = exact_edges
        self.act = SnakeBeta(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.exact_edges:
            return snake_alias_fused_cm(x, self.act.alpha, self.act.beta, exact_edges=False)
        from ..ops.snake_cuda import snake_alias

        return snake_alias(x, self.act.alpha, self.act.beta, self.variant)
