"""Convolutions with the reference torch parameter names.

Weight norm is explicit: `weight_g`/`weight_v` parameters and
w = g * v / (||v|| + 1e-12), as the JAX package computes it
(whisper_vits_svc_tpu/nn/conv.py:41-43), so that a reference `.pth`
state_dict loads without renaming. Conv1d takes the norm per output channel
over (I/groups, K) and Conv2d over (I, kh, kw); ConvTranspose1d, whose torch
weight is (I, O, K), per input channel over (O, K).

Initializers mirror the JAX package's (torch's defaults): U(-b, b) with
b = 1/sqrt(fan_in), and g = ||v|| so that w == v at init.

`fold_weight_norm` turns every `weight_g`/`weight_v` pair of a state_dict
into the plain `weight` (JAX nn/conv.py:409-435; the reference calls
`remove_weight_norm()` before inference, vits/models.py:241-243). A
weight-norm module that loads such a state_dict folds itself first and then
skips the norm on each call; a folded module that loads a pair folds the
pair on the way in.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


def wn_weight(g: torch.Tensor, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """g * v / (||v|| + 1e-12), the norm over every dim but `dim`."""
    norm = v.square().sum(dim=tuple(d for d in range(v.dim()) if d != dim),
                          keepdim=True).sqrt()
    return g * v / (norm + 1e-12)


def _wn_dim(g: torch.Tensor) -> int:
    """The dim a weight_g keeps (torch.nn.utils.weight_norm's `dim`): its
    one axis longer than 1, else 0."""
    return next((d for d, n in enumerate(g.shape) if n != 1), 0)


def fold_weight_norm(state_dict: Mapping[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A new state_dict with every `<name>.weight_g`/`<name>.weight_v` pair
    replaced by `<name>.weight` = wn_weight(g, v), computed in the pair's
    dtype on its device; every other entry is kept as it is."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    with torch.no_grad():
        for k, t in state_dict.items():
            base = k[: -len("weight_g")]
            if k.endswith("weight_g") and base + "weight_v" in state_dict:
                out[base + "weight"] = wn_weight(t, state_dict[base + "weight_v"], _wn_dim(t))
            elif not (k.endswith("weight_v") and k[: -len("weight_v")] + "weight_g" in state_dict):
                out[k] = t
    return out


class WeightNormed(nn.Module):
    """A kernel held as weight_g/weight_v (weight norm over every dim but
    `wn_dim`) or, folded, as a plain `weight`. `kernel()` is the kernel
    either way; `load_state_dict` takes either form (see the module
    docstring)."""

    weight_norm = False
    wn_dim = 0

    def kernel(self) -> torch.Tensor:
        if self.weight_norm:
            return wn_weight(self.weight_g, self.weight_v, self.wn_dim)
        return self.weight

    def fold_(self) -> None:
        """Replace weight_g/weight_v by the plain weight they make."""
        with torch.no_grad():
            w = self.kernel()
        del self.weight_g, self.weight_v
        self.weight_norm = False
        self.weight = nn.Parameter(w)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        g, v, w = prefix + "weight_g", prefix + "weight_v", prefix + "weight"
        if self.weight_norm and w in state_dict and g not in state_dict:
            self.fold_()
        elif not self.weight_norm and g in state_dict and v in state_dict:
            with torch.no_grad():
                state_dict[w] = wn_weight(state_dict.pop(g), state_dict.pop(v), self.wn_dim)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _cpu_bf16_safe(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *args):
    """conv(x, w, b, *args). A bfloat16 convolution on the CPU runs in
    float32 on the bfloat16 values and is rounded once, as cuDNN's is:
    oneDNN's bfloat16 convolutions return wrong values for inputs narrower
    than the kernel's padded reach (the MRD's width-2 rows, kernel 9,
    stride 2) and non-finite weight gradients for the MSD's grouped
    width-2 layer."""
    if x.dtype != torch.bfloat16 or x.device.type != "cpu":
        return conv(x, w, b, *args)
    return conv(x.float(), w.float(), None if b is None else b.float(), *args).to(x.dtype)


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


class Conv1d(WeightNormed):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel (weight norm computed in the parameters' dtype) and the
        bias are cast to the input's dtype, as the JAX package casts them."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return _cpu_bf16_safe(F.conv1d, x, self.kernel().to(x.dtype), bias, self.stride,
                              self.padding, self.dilation, self.groups)

    def forward_ntc(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] in and out; a 1x1 conv is one matmul, no transposes."""
        w = self.kernel()
        if w.shape[2] == 1 and self.stride == 1 and self.padding == 0 and self.groups == 1:
            return F.linear(x, w[:, :, 0], self.bias)
        return self(x.transpose(1, 2)).transpose(1, 2)


class Conv2d(WeightNormed):
    """Weight-norm torch.nn.Conv2d on [B, C, H, W] (the MPD and MRD stacks);
    weight_g is [O, 1, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight_norm = True
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = self.weight_v[0].numel()
        _init_wn_(self.weight_g, self.weight_v, fan_in, generator)
        uniform_init_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Weight norm in the parameters' dtype, then the kernel and the bias
        cast to the input's dtype (JAX nn/conv.py:373)."""
        return _cpu_bf16_safe(F.conv2d, x, self.kernel().to(x.dtype),
                              self.bias.to(x.dtype), self.stride, self.padding)


class ConvTranspose1d(WeightNormed):
    """Weight-norm torch.nn.ConvTranspose1d on [B, C, T]; output length is
    (T - 1) * stride - 2 * padding + kernel_size (T * stride in the
    generator, where padding = (kernel_size - stride) // 2)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_norm = True
        self.weight_g = nn.Parameter(torch.empty(in_channels, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        # torch's fan_in for a transposed conv: out_channels * kernel_size
        fan_in = self.weight_v.shape[1] * self.weight_v.shape[2]
        _init_wn_(self.weight_g, self.weight_v, fan_in, generator)
        uniform_init_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.kernel(),
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

