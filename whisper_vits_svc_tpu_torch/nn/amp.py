"""AMP (anti-aliased multi-periodicity) residual block on [B, C, T]
(reference vits_decoder/bigv.py:19-64): per dilation, SnakeAlias -> dilated
weight-norm conv -> SnakeAlias -> conv, added to the input. The reference's
`activations` list interleaves the two snakes: act1 of dilation j is
`activations.{2j}`, act2 is `activations.{2j+1}`.

`fused_iter=True` runs each dilation iteration as one `amp_iter` call
(ops/amp_cuda.py) where `use_fused_iter` takes the shape, the counterpart of
the JAX block's `pallas_fused_iter`. The parameters are the same, so one
checkpoint serves both forms. The kernel is forward only: on the card the
fused form raises where autograd would record a graph.
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv1d
from .snake import SnakeAlias


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class AMPBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: tuple[int, ...] = (1, 3, 5), snake_variant: str = "direct",
                 fused_iter: bool = False, snake_exact_edges: bool = True):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, tuple(dilation)
        # the fused kernel has exact edges only, as JAX's pallas_fused_iter
        self.fused_iter = fused_iter and snake_exact_edges
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1),
                   weight_norm=True)
            for _ in dilation)
        self.activations = nn.ModuleList(SnakeAlias(channels, snake_variant, snake_exact_edges)
                                         for _ in range(2 * len(dilation)))

    def init_weights(self, generator: torch.Generator) -> None:
        for c1, c2 in zip(self.convs1, self.convs2):
            c1.init_weights(generator)
            c2.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] -> [B, C, T]."""
        if self.fused_iter:
            from ..ops.amp_cuda import amp_iter, use_fused_iter

            if use_fused_iter(x.shape[1], x.shape[2], x.shape[0]):
                for j, (c1, c2, d) in enumerate(zip(self.convs1, self.convs2, self.dilation)):
                    act1, act2 = self.activations[2 * j].act, self.activations[2 * j + 1].act
                    x = amp_iter(x, c1.kernel(), c1.bias, act1.alpha, act1.beta,
                                 c2.kernel(), c2.bias, act2.alpha, act2.beta,
                                 self.kernel_size, d)
                return x
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c1(self.activations[2 * j](x))
            xt = c2(self.activations[2 * j + 1](xt))
            x = xt + x
        return x
