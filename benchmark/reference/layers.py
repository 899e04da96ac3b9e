"""Plain PyTorch layers of so-vits-svc 5.0 (PlayVoice/whisper-vits-svc:
vits/modules.py, vits/attentions.py, vits_decoder/{bigv,nsf,alias}.py),
frozen as the benchmark's reference.

Nothing here is fused or hand-written: every convolution is one torch call,
the anti-aliased snake is the reference chain itself (replicate pad, x2
Kaiser-sinc transposed convolution, SnakeBeta, replicate pad, x2 strided
lowpass), weight norm is computed on every call from `weight_g` and
`weight_v`. Parameter names are the reference state_dict's. Random draws
take an explicit torch.Generator and are made in the graph's order; on the
meta device (FLOP counting) they take none.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def randn(shape, generator, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "meta":
        return torch.randn(shape, device="meta", dtype=like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def rand(shape, generator, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "meta":
        return torch.rand(shape, device="meta")
    return torch.rand(shape, generator=generator, device=like.device)


def randn_ntc(x: torch.Tensor, generator) -> torch.Tensor:
    """Normal draws for [B, C, T] `x`, made in the [B, T, C] order the
    reference's channel-last graph draws them in."""
    b, c, t = x.shape
    return randn((b, t, c), generator, x).transpose(1, 2)


def dropout(x: torch.Tensor, p: float, generator, ntc: bool = False) -> torch.Tensor:
    """Inverted dropout: keep where a uniform draw >= p, kept values / (1 - p);
    ntc: the draws of [B, C, T] `x` made in [B, T, C] order."""
    if ntc:
        b, c, t = x.shape
        keep = (rand((b, t, c), generator, x) >= p).transpose(1, 2)
    else:
        keep = rand(x.shape, generator, x) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g * v / (||v|| + 1e-12), the norm over every dim but the first."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / (norm + 1e-12)


class WNParams(nn.Module):
    """A kernel held as weight_g / weight_v, or as a plain `weight`."""

    def _init_kernel(self, shape, wn: bool) -> None:
        if wn:
            self.weight_g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))

    def kernel(self) -> torch.Tensor:
        if hasattr(self, "weight_v"):
            return weight_norm(self.weight_g, self.weight_v)
        return self.weight


class Conv1d(WNParams):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1, groups=1,
                 bias=True, wn=False):
        super().__init__()
        self.args = (stride, padding, dilation, groups)
        self._init_kernel((cout, cin // groups, k), wn)
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):  # [B, C, T]
        return F.conv1d(x, self.kernel(), self.bias, *self.args)


class Conv2d(WNParams):
    def __init__(self, cin, cout, k, stride, padding):
        super().__init__()
        self.args = (tuple(stride), tuple(padding))
        self._init_kernel((cout, cin) + tuple(k), True)
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.conv2d(x, self.kernel(), self.bias, *self.args)


class ConvTranspose1d(WNParams):
    def __init__(self, cin, cout, k, stride, padding):
        super().__init__()
        self.args = (stride, padding)
        self._init_kernel((cin, cout, k), True)
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.conv_transpose1d(x, self.kernel(), self.bias, *self.args)


class LayerNorm(nn.Module):
    """LayerNorm over channels of [B, C, T], reference names gamma / beta."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.transpose(1, -1)
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, self.eps).transpose(1, -1)


# ---------------------------------------------------------------- the snake

@lru_cache(maxsize=None)
def kaiser_sinc(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, sum 1 (vits_decoder/alias/filter.py)."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    t = (np.arange(-half, half) + 0.5) if kernel_size % 2 == 0 else np.arange(kernel_size) - half
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    return (filt / filt.sum()).astype(np.float32)


def _lowpass(x: torch.Tensor) -> torch.Tensor:
    """The 12-tap x2 filter as a depthwise kernel [C, 1, 12]."""
    f = torch.from_numpy(kaiser_sinc(0.25, 0.3, 12)).to(device=x.device, dtype=x.dtype)
    return f[None, None].expand(x.shape[1], 1, 12)


def snake_alias(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Activation1d(SnakeBeta) of the reference on [B, C, T]
    (vits_decoder/alias/{act,resample}.py): x2 up, snake, x2 down."""
    c = x.shape[1]
    f = _lowpass(x)
    up = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), f, stride=2, groups=c)
    up = up[..., 15:-15]
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    s = up + 1.0 / (b + 1e-9) * torch.sin(up * a).square()
    return F.conv1d(F.pad(s, (5, 6), mode="replicate"), f, stride=2, groups=c)


class SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return snake_alias(x, self.act.alpha, self.act.beta)


class AMPBlock(nn.Module):
    """vits_decoder/bigv.py: per dilation snake -> dilated conv -> snake ->
    conv, plus the input; activations interleave act1 / act2."""

    def __init__(self, channels: int, k: int, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, k, dilation=d,
                                           padding=(k * d - d) // 2, wn=True) for d in dilation)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, k, padding=(k - 1) // 2, wn=True)
                                    for _ in dilation)
        self.activations = nn.ModuleList(Activation(channels) for _ in range(2 * len(dilation)))

    def forward(self, x):
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(self.activations[2 * j + 1](c1(self.activations[2 * j](x))))
            x = xt + x
        return x


# ------------------------------------------------------------- attention

class GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def _band_to_dense(band: torch.Tensor, w: int) -> torch.Tensor:
    """[..., L, 2w+1] (column c: key i + c - w) -> [..., L, L], 0 off band."""
    n = band.shape[-2]
    i = torch.arange(n, device=band.device)
    col = i[None, :] - i[:, None] + w
    valid = (col >= 0) & (col <= 2 * w)
    dense = torch.gather(band, -1, col.clamp(0, 2 * w).expand(band.shape[:-1] + (n,)))
    return torch.where(valid, dense, torch.zeros((), dtype=band.dtype, device=band.device))


def _dense_to_band(x: torch.Tensor, w: int) -> torch.Tensor:
    n = x.shape[-1]
    i = torch.arange(n, device=x.device)
    j = i[:, None] + torch.arange(2 * w + 1, device=x.device)[None, :] - w
    valid = (j >= 0) & (j < n)
    band = torch.gather(x, -1, j.clamp(0, n - 1).expand(x.shape[:-1] + (2 * w + 1,)))
    return torch.where(valid, band, torch.zeros((), dtype=x.dtype, device=x.device))


class MultiHeadAttention(nn.Module):
    """vits/attentions.py MultiHeadAttention with relative keys and values
    over a +-window shared by the heads, masked fill -1e4."""

    def __init__(self, channels: int, n_heads: int, window: int, p_dropout: float):
        super().__init__()
        self.h, self.dk, self.window, self.p = n_heads, channels // n_heads, window, p_dropout
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            setattr(self, name, Conv1d(channels, channels, 1))
        self.emb_rel_k = nn.Parameter(torch.empty(1, 2 * window + 1, self.dk))
        self.emb_rel_v = nn.Parameter(torch.empty(1, 2 * window + 1, self.dk))

    def forward(self, x, mask2d, train, generator):  # x [B, C, T]
        b, c, t = x.shape

        def heads(y):
            return y.view(b, self.h, self.dk, t).transpose(2, 3)  # [B, H, T, dk]

        q = heads(self.conv_q(x)) / math.sqrt(self.dk)
        k, v = heads(self.conv_k(x)), heads(self.conv_v(x))
        w = min(self.window, t - 1)
        lo = self.window - w
        rel_k = self.emb_rel_k[0, lo : lo + 2 * w + 1]
        rel_v = self.emb_rel_v[0, lo : lo + 2 * w + 1]
        scores = q @ k.transpose(-1, -2) + _band_to_dense(q @ rel_k.t(), w)
        scores = scores.masked_fill(mask2d == 0, -1e4)
        p = F.softmax(scores, dim=-1)
        if train:
            p = dropout(p, self.p, generator)
        out = p @ v + _dense_to_band(p, w) @ rel_v
        return self.conv_o(out.transpose(2, 3).reshape(b, c, t))


class FFN(nn.Module):
    def __init__(self, channels: int, filters: int, k: int, p_dropout: float):
        super().__init__()
        self.k, self.p = k, p_dropout
        self.conv_1 = Conv1d(channels, filters, k)
        self.conv_2 = Conv1d(filters, channels, k)

    def forward(self, x, mask, train, generator):
        pad = ((self.k - 1) // 2, self.k // 2)
        x = torch.relu(self.conv_1(F.pad(x * mask, pad)))
        if train:
            x = dropout(x, self.p, generator)
        return self.conv_2(F.pad(x * mask, pad)) * mask


class Encoder(nn.Module):
    """vits/attentions.py Encoder: post-norm attention + FFN layers."""

    def __init__(self, hidden: int, filters: int, n_heads: int, n_layers: int, k: int,
                 p_dropout: float, window: int = 4):
        super().__init__()
        self.p = p_dropout
        self.attn_layers = nn.ModuleList(MultiHeadAttention(hidden, n_heads, window, p_dropout)
                                         for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(FFN(hidden, filters, k, p_dropout)
                                        for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))

    def forward(self, x, mask, train=False, generator=None):  # [B, C, T], [B, 1, T]
        mask2d = mask[:, :, :, None] * mask[:, :, None, :]
        x = x * mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            y = attn(x, mask2d, train, generator)
            if train:
                y = dropout(y, self.p, generator, ntc=True)
            x = n1(x + y)
            y = ffn(x, mask, train, generator)
            if train:
                y = dropout(y, self.p, generator, ntc=True)
            x = n2(x + y)
        return x * mask


# ------------------------------------------------------------ WN and flow

class WN(nn.Module):
    """vits/modules.py WN: gated dilated convolutions, optionally
    conditioned on a global vector through one 1x1 cond_layer."""

    def __init__(self, hidden: int, k: int, n_layers: int, gin: int = 0):
        super().__init__()
        self.h = hidden
        if gin:
            self.cond_layer = Conv1d(gin, 2 * hidden * n_layers, 1, wn=True)
        self.in_layers = nn.ModuleList(Conv1d(hidden, 2 * hidden, k, padding=(k - 1) // 2, wn=True)
                                       for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1, wn=True)
            for i in range(n_layers))

    def forward(self, x, mask, g=None):  # [B, C, T], [B, 1, T], g [B, gin, 1]
        h = self.h
        if g is not None:
            g = self.cond_layer(g)
        out = torch.zeros_like(x)
        n = len(self.in_layers)
        for i, (cin, crs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            acts = cin(x)
            if g is not None:
                acts = acts + g[:, 2 * h * i : 2 * h * (i + 1)]
            acts = torch.tanh(acts[:, :h]) * torch.sigmoid(acts[:, h:])
            rs = crs(acts)
            if i < n - 1:
                x = (x + rs[:, :h]) * mask
                out = out + rs[:, h:]
            else:
                out = out + rs
        return out * mask


class Coupling(nn.Module):
    """Mean-only residual coupling with speaker-adaptive whitening (SNAC)."""

    def __init__(self, channels: int, hidden: int, k: int, n_layers: int, gin: int):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden, 1)
        self.enc = WN(hidden, k, n_layers)
        self.post = Conv1d(hidden, self.half, 1)
        self.snac = Conv1d(gin, 2 * self.half, 1)

    def forward(self, x, mask, g, reverse):  # x [B, C, T], g [B, gin]
        half = self.half
        spk = self.snac(g[:, :, None])
        sm, sv = spk[:, :half], spk[:, half:]
        x0, x1 = x[:, :half], x[:, half:]
        h = self.pre((x0 - sm) * torch.exp(-sv) * mask) * mask
        m = self.post(self.enc(h, mask)) * mask
        logdet = torch.sum(sv * mask, dim=(1, 2))
        if not reverse:
            x1 = (m + (x1 - sm) * torch.exp(-sv) * mask) * mask
            logdet = -logdet
        else:
            x1 = (sm + (x1 - m) * mask * torch.exp(sv)) * mask
        return torch.cat([x0, x1], dim=1), logdet


class Flip(nn.Module):
    pass


class Flow(nn.Module):
    def __init__(self, channels: int, hidden: int, k: int, n_layers: int, n_flows: int, gin: int):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(Coupling(channels, hidden, k, n_layers, gin))
            self.flows.append(Flip())

    def forward(self, x, mask, g, reverse=False):
        logdet = torch.zeros(x.shape[0], device=x.device)
        layers = list(self.flows[::2])
        if not reverse:
            for layer in layers:
                x, ld = layer(x, mask, g, False)
                logdet = logdet + ld
                x = torch.flip(x, dims=(1,))
        else:
            for layer in reversed(layers):
                x = torch.flip(x, dims=(1,))
                x, ld = layer(x, mask, g, True)
                logdet = logdet + ld
        return x, logdet


# ------------------------------------------------------------------- NSF

MERGE_W = (0.2942, -0.2243, 0.0033, -0.0056, -0.0020, -0.0046,
           0.0221, -0.0083, -0.0241, -0.0036, -0.0581)
MERGE_B = 0.0008
N_HARMONICS = 11


def excitation(f0: torch.Tensor, hop: int, sr: int, generator=None, phase0=None,
               return_phase: bool = False):
    """SourceModuleHnNSF on frame F0 [B, T] -> [B, T*hop, 1]: 11 harmonic
    sines whose phase is summed per frame (the fractional increment of each
    frame, an exclusive cumsum, a ramp within the frame), amplitude 0.1,
    gated by voicing, merged by the fixed linear layer and tanh. With a
    generator: random initial phases (fundamental pinned) and noise.
    phase0 [B, 11] continues a carried phase; return_phase gives the phase
    after the last frame."""
    b, t = f0.shape
    dev = f0.device
    fh = f0.float()[..., None] * torch.arange(1, N_HARMONICS + 1, dtype=torch.float32, device=dev)
    inc = fh * (hop / sr)
    csum = torch.cumsum(inc - torch.floor(inc), dim=1)
    zeros = torch.zeros(b, 1, N_HARMONICS, device=dev)
    start = zeros if phase0 is None else phase0.float()[:, None, :]
    base = start + torch.cat([zeros, csum[:, :-1]], dim=1)
    base = base - torch.floor(base)
    end = start[:, 0] + csum[:, -1]
    end = end - torch.floor(end)
    if generator is not None:
        ini = rand((b, 1, N_HARMONICS), generator, fh)
        ini[:, :, 0] = 0.0
        base = base + ini
    ramp = torch.arange(1, hop + 1, dtype=torch.float32, device=dev)
    phase = base[:, :, None, :] + ramp[None, None, :, None] * (fh[:, :, None, :] / sr)
    sines = torch.sin(2.0 * math.pi * phase).reshape(b, t * hop, N_HARMONICS) * 0.1
    uv = torch.repeat_interleave((f0 > 0.0).float(), hop, dim=1)[..., None]
    out = sines * uv
    if generator is not None:
        amp = uv * 0.003 + (1.0 - uv) * 0.1 / 3.0
        out = out + amp * randn(sines.shape, generator, sines)
    w = torch.tensor(MERGE_W, dtype=torch.float32, device=dev)
    out = torch.tanh(out @ w[:, None] + MERGE_B)
    return (out, end) if return_phase else out


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Mel-scale F0 bins 1..255 (vits/utils.py f0_to_coarse)."""
    mel_min = 1127.0 * math.log(1.0 + 50.0 / 700.0)
    mel_max = 1127.0 * math.log(1.0 + 1100.0 / 700.0)
    m = 1127.0 * torch.log(1.0 + f0.float() / 700.0)
    m = torch.where(m > 0, (m - mel_min) * 254 / (mel_max - mel_min) + 1.0, m)
    return torch.floor(m.clamp(1.0, 255.0) + 0.5).long()
