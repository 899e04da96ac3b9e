"""WaveNet residual block (WN): gated dilated conv stack, optionally
conditioned on a global vector (reference vits/modules.py:126-211). The SNAC
flow uses it unconditioned; the posterior encoder conditions it on the
speaker: one weight-norm 1x1 `cond_layer` makes 2*h*n_layers channels, and
layer i adds its slice [2hi, 2h(i+1)) before the gate (JAX nn/wn.py:72-93).

Public layout: x [B, T, C], x_mask [B, T, 1], g [B, 1, gin] or [B, T, gin];
the stack runs in [B, C, T].
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv1d


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1, weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(Conv1d(h, 2 * h, kernel_size, dilation=dilation,
                                         padding=padding, weight_norm=True))
            res_skip = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(Conv1d(h, res_skip, 1, weight_norm=True))

    def init_weights(self, generator: torch.Generator) -> None:
        if hasattr(self, "cond_layer"):
            self.cond_layer.init_weights(generator)
        for conv_in, conv_rs in zip(self.in_layers, self.res_skip_layers):
            conv_in.init_weights(generator)
            conv_rs.init_weights(generator)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1], g [B, 1 or T, gin] -> [B, T, C]."""
        h = self.hidden_channels
        x, mask = x.transpose(1, 2), x_mask.transpose(1, 2)
        if g is not None:
            g = self.cond_layer(g.transpose(1, 2))  # [B, 2*h*n_layers, 1 or T]
        output = torch.zeros_like(x)
        n = len(self.in_layers)
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            if g is not None:
                x_in = x_in + g[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = conv_rs(acts)
            if i < n - 1:
                x = (x + res_skip[:, :h]) * mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return (output * mask).transpose(1, 2)
