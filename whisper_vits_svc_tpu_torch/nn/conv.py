"""Convolutions with the reference torch parameter names.

Weight norm is explicit: `weight_g`/`weight_v` parameters and
w = g * v / (||v|| + 1e-12), as the JAX package computes it
(whisper_vits_svc_tpu/nn/conv.py:41-43), so that a reference `.pth`
state_dict loads without renaming. Conv1d takes the norm per output channel
over (I/groups, K) and Conv2d over (I, kh, kw); ConvTranspose1d, whose torch
weight is (I, O, K), per input channel over (O, K).

Initializers mirror the JAX package's (torch's defaults): U(-b, b) with
b = 1/sqrt(fan_in), and g = ||v|| so that w == v at init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def wn_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g * v / (||v|| + 1e-12), the norm over every dim but the first."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / (norm + 1e-12)


def uniform_init_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _init_wn_(g: nn.Parameter, v: nn.Parameter, fan_in: int,
              generator: torch.Generator) -> None:
    uniform_init_(v, fan_in, generator)
    with torch.no_grad():
        norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        g.copy_(norm)


class Conv1d(nn.Module):
    """torch.nn.Conv1d semantics on [B, C, T]; `forward_ntc` takes [B, T, C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, weight_norm: bool = False, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        shape = (out_channels, in_channels // groups, kernel_size)
        self.weight_norm = weight_norm
        if weight_norm:
            self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_weights(self, generator: torch.Generator, zero: bool = False) -> None:
        if zero:
            with torch.no_grad():
                self.weight.zero_()
                if self.bias is not None:
                    self.bias.zero_()
            return
        w = self.weight_v if self.weight_norm else self.weight
        fan_in = w.shape[1] * w.shape[2]
        if self.weight_norm:
            _init_wn_(self.weight_g, self.weight_v, fan_in, generator)
        else:
            uniform_init_(self.weight, fan_in, generator)
        if self.bias is not None:
            uniform_init_(self.bias, fan_in, generator)

    def kernel(self) -> torch.Tensor:
        return wn_weight(self.weight_g, self.weight_v) if self.weight_norm else self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.kernel(), self.bias, self.stride, self.padding,
                        self.dilation, self.groups)

    def forward_ntc(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] in and out; a 1x1 conv is one matmul, no transposes."""
        w = self.kernel()
        if w.shape[2] == 1 and self.stride == 1 and self.padding == 0 and self.groups == 1:
            return F.linear(x, w[:, :, 0], self.bias)
        return self(x.transpose(1, 2)).transpose(1, 2)


class Conv2d(nn.Module):
    """Weight-norm torch.nn.Conv2d on [B, C, H, W] (the MPD and MRD stacks);
    weight_g is [O, 1, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = self.weight_v[0].numel()
        _init_wn_(self.weight_g, self.weight_v, fan_in, generator)
        uniform_init_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, wn_weight(self.weight_g, self.weight_v), self.bias, self.stride,
                        self.padding)


class ConvTranspose1d(nn.Module):
    """Weight-norm torch.nn.ConvTranspose1d on [B, C, T]; output length is
    (T - 1) * stride - 2 * padding + kernel_size (T * stride in the
    generator, where padding = (kernel_size - stride) // 2)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_g = nn.Parameter(torch.empty(in_channels, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        # torch's fan_in for a transposed conv: out_channels * kernel_size
        fan_in = self.weight_v.shape[1] * self.weight_v.shape[2]
        _init_wn_(self.weight_g, self.weight_v, fan_in, generator)
        uniform_init_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, wn_weight(self.weight_g, self.weight_v),
                                  self.bias, self.stride, self.padding)


class LayerNorm(nn.Module):
    """Channel LayerNorm on [B, T, C] with the reference's gamma/beta names."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, self.eps)

