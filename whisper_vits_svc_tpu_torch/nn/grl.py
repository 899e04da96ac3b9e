"""Gradient-reversal speaker adversary (reference vits/modules_grl.py:11-63,
JAX nn/grl.py).

`GradientReversal` is the identity forward and scales the cotangent by
-lambda backward. `SpeakerClassifier` predicts the speaker embedding from the
prior encoder's hidden through the reversal: three weight-norm k=5 convs with
ReLU between, then a mean over time. Its torch Sequential holds the reversal
at index 0, so the convs are `classifier.{1,3,5}` as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv1d


class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambda_ * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    """The identity forward; the gradient times -lambda_ backward."""
    return GradientReversal.apply(x, lambda_)


class GRL(nn.Module):
    def __init__(self, lambda_reversal: float = 1.0):
        super().__init__()
        self.lambda_reversal = lambda_reversal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gradient_reversal(x, self.lambda_reversal)


class SpeakerClassifier(nn.Module):
    def __init__(self, embed_dim: int, spk_dim: int, lambda_reversal: float = 1.0):
        super().__init__()
        self.classifier = nn.Sequential(
            GRL(lambda_reversal),
            Conv1d(embed_dim, embed_dim, 5, padding=2, weight_norm=True),
            nn.ReLU(),
            Conv1d(embed_dim, embed_dim, 5, padding=2, weight_norm=True),
            nn.ReLU(),
            Conv1d(embed_dim, spk_dim, 5, padding=2, weight_norm=True),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        for i in (1, 3, 5):
            self.classifier[i].init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, embed_dim] -> [B, spk_dim] speaker prediction."""
        return self.classifier(x.transpose(1, 2)).mean(dim=2)
