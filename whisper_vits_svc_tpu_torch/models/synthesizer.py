"""VITS inference graph: prior text encoder, SNAC flow in reverse, NSF-BigVGAN
generator (reference vits/models.py:14-52, :211-256).

Public layout: latents [B, T, C], masks [B, T, 1], audio [B, S, 1]. The
prior noise is passed in (`noise`) or drawn from an explicit
torch.Generator; noise_scale=0 gives the deterministic mean path.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import RelPosTransformer
from ..nn.conv import Conv1d
from ..nn.flow import ResidualCouplingBlock
from ..utils.pitch import f0_to_coarse
from .generator import Generator


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, T, 1] float mask (reference commons.sequence_mask)."""
    idx = torch.arange(max_length, device=lengths.device)
    return (idx[None, :] < lengths[:, None]).float()[..., None]


class TextEncoder(nn.Module):
    """PPG + content-vec + quantized-F0 prior encoder (vits/models.py:14-52)."""

    def __init__(self, in_channels: int = 1280, vec_channels: int = 256,
                 out_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 640, n_heads: int = 2, n_layers: int = 6,
                 kernel_size: int = 3):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 5, padding=2)
        self.hub = Conv1d(vec_channels, hidden_channels, 5, padding=2)
        self.pit = nn.Embedding(256, hidden_channels)
        self.enc = RelPosTransformer(hidden_channels, filter_channels, n_heads, n_layers,
                                     kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        self.pre.init_weights(generator)
        self.hub.init_weights(generator)
        with torch.no_grad():
            self.pit.weight.normal_(0.0, 1.0, generator=generator)
        self.enc.init_weights(generator)
        self.proj.init_weights(generator)

    def forward(self, ppg: torch.Tensor, lengths: torch.Tensor, vec: torch.Tensor,
                f0_coarse: torch.Tensor, noise_scale: float = 1.0,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """ppg [B,T,ppg_dim], vec [B,T,vec_dim], f0_coarse [B,T] int ->
        (z, m, logs, mask, x). noise [B,T,out] is drawn from `generator` when
        not given (and not drawn at all when noise_scale == 0)."""
        x_mask = sequence_mask(lengths, ppg.shape[1]).to(ppg.dtype)
        x = self.pre.forward_ntc(ppg) * x_mask
        v = self.hub.forward_ntc(vec) * x_mask
        x = x + v + self.pit(f0_coarse)
        x = self.enc(x * x_mask, x_mask)
        stats = self.proj.forward_ntc(x) * x_mask
        m, logs = stats[..., : self.out_channels], stats[..., self.out_channels :]
        if noise_scale == 0:
            z = m * x_mask
        else:
            if noise is None:
                noise = torch.randn(m.shape, generator=generator, device=m.device,
                                    dtype=m.dtype)
            z = (m + noise * torch.exp(logs) * noise_scale) * x_mask
        return z, m, logs, x_mask, x


class SynthesizerInfer(nn.Module):
    """Inference graph without the posterior (reference vits/models.py:211-256)."""

    def __init__(self, ppg_dim: int = 1280, vec_dim: int = 256, spk_dim: int = 256,
                 inter_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 640, upsample_rates=(5, 4, 4, 2, 2),
                 upsample_kernel_sizes=(15, 8, 8, 4, 4), upsample_initial_channel: int = 320,
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3, sampling_rate: int = 32000,
                 enc_p_layers: int = 6, flow_wn_layers: int = 4, n_flows: int = 4):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.sampling_rate = sampling_rate
        self.inter_channels = inter_channels
        self.enc_p = TextEncoder(ppg_dim, vec_dim, inter_channels, hidden_channels,
                                 filter_channels, 2, enc_p_layers, 3)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1,
                                          flow_wn_layers, n_flows=n_flows,
                                          gin_channels=spk_dim)
        self.dec = Generator(inter_channels, upsample_initial_channel, upsample_rates,
                             upsample_kernel_sizes, resblock_kernel_sizes,
                             resblock_dilation_sizes, spk_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights with the JAX package's initializers."""
        self.enc_p.init_weights(generator)
        self.flow.init_weights(generator)
        self.dec.init_weights(generator)

    def forward(self, ppg: torch.Tensor, vec: torch.Tensor, pit: torch.Tensor,
                spk: torch.Tensor, ppg_l: torch.Tensor, source: torch.Tensor,
                noise_scale: float = 1.0, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Chunk synthesis (models.py:251-256); pit [B, T] Hz, source
        [B, T*hop, 1] precomputed -> audio [B, T*hop, 1]."""
        z_p, _, _, ppg_mask, _ = self.enc_p(ppg, ppg_l, vec, f0_to_coarse(pit),
                                            noise_scale, noise, generator)
        z, _ = self.flow(z_p, ppg_mask, g=spk, reverse=True)
        return self.dec(spk, z * ppg_mask, har_source=source)
