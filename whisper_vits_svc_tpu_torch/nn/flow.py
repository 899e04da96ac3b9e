"""SNAC residual-coupling normalizing flow (reference vits/modules.py:250-324,
vits/models.py:55-98).

Each coupling whitens both halves with speaker statistics from a 1x1 conv on
the speaker embedding and shifts one half by a WN prediction from the other
(mean only). Couplings alternate with channel flips; the torch module list
holds the flips too, so couplings sit at the even indices (`flows.{2i}`).

Public layout: x [B, T, C], x_mask [B, T, 1], g [B, spk_dim].
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv1d
from .wn import WN


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers)
        self.post = Conv1d(hidden_channels, self.half, 1)
        self.snac = Conv1d(gin_channels, 2 * self.half, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        self.snac.init_weights(generator)
        self.pre.init_weights(generator)
        self.enc.init_weights(generator)
        self.post.init_weights(generator, zero=True)  # identity at init

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                reverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        half = self.half
        speaker = self.snac.forward_ntc(g[:, None, :])  # [B, 1, 2*half]
        speaker_m, speaker_v = speaker[..., :half], speaker[..., half:]
        x0, x1 = x[..., :half], x[..., half:]
        x0_norm = (x0 - speaker_m) * torch.exp(-speaker_v) * x_mask
        h = self.pre.forward_ntc(x0_norm) * x_mask
        h = self.enc(h, x_mask)
        m = self.post.forward_ntc(h) * x_mask
        # mean-only coupling: logs == 0, so exp(logs) factors drop out
        speaker_logdet = torch.sum(speaker_v * x_mask, dim=(1, 2))
        if not reverse:
            x1_norm = (x1 - speaker_m) * torch.exp(-speaker_v) * x_mask
            x1 = (m + x1_norm) * x_mask
            logdet = -speaker_logdet
        else:
            x1 = (x1 - m) * x_mask
            x1 = (speaker_m + x1 * torch.exp(speaker_v)) * x_mask
            logdet = speaker_logdet
        return torch.cat([x0, x1], dim=-1), logdet


def flip(x: torch.Tensor) -> torch.Tensor:
    """Channel-order flip between couplings (reference vits/modules.py:225-229)."""
    return torch.flip(x, dims=(-1,))


class Flip(nn.Module):
    """`flip` as a module, at the reference's odd indices of `flows`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flip(x)


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.flows[::2]:
            layer.init_weights(generator)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                reverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        total_logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        if not reverse:
            for layer, flip in zip(self.flows[::2], self.flows[1::2]):
                x, logdet = layer(x, x_mask, g)
                total_logdet = total_logdet + logdet
                x = flip(x)
        else:
            for layer, flip in zip(reversed(self.flows[::2]), reversed(self.flows[1::2])):
                x = flip(x)
                x, logdet = layer(x, x_mask, g, reverse=True)
                total_logdet = total_logdet + logdet
        return x, total_logdet
