"""NSF-BigVGAN generator (reference vits_decoder/generator.py:15-200):
SpeakerAdapter conditional layer norm, Mish-gated pre-conv, five weight-norm
ConvTranspose1d upsamplers (x5*4*4*2*2 = x320), each followed by the NSF
excitation injected through a strided noise conv and three averaged
AMPBlocks, then the anti-aliased snake and a bias-free k=7 projection.

In inference the excitation is precomputed (`har_source`, whole utterance,
nn/nsf.py). In training (JAX models/generator.py:95-116) it is computed in
the graph from the segment's frame F0, with random phases and noise, and the
latent gets a +1 sigma perturbation; both draws come from an explicit
torch.Generator. Public layout: spk [B, spk_dim], x [B, T, C], har_source
[B, T*hop, 1] or f0_frames [B, T] -> audio [B, T*hop, 1]; the stages run in
[B, C, T].

`snake_variant` names the forward snake kernel of every SnakeAlias and
`amp_fused_iter` turns the AMP blocks' fused iteration on (nn/amp.py); both
are forward-only alternatives of the default path with the same parameters.
`snake_exact_edges=False` is the JAX package's fast_edges: every snake
zero-pads inside its FIRs and runs the plain version, on the card too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.amp import AMPBlock
from ..nn.conv import Conv1d, ConvTranspose1d
from ..nn.nsf import source_hn_nsf
from ..nn.snake import SnakeAlias
from ..utils import rng


class SpeakerAdapter(nn.Module):
    """Speaker-conditional layer norm over channels (generator.py:15-47)."""

    def __init__(self, speaker_dim: int, adapter_dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.W_scale = nn.Linear(speaker_dim, adapter_dim)
        self.W_bias = nn.Linear(speaker_dim, adapter_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.W_scale.weight.zero_()
            self.W_scale.bias.fill_(1.0)
            self.W_bias.weight.zero_()
            self.W_bias.bias.zero_()

    def forward(self, x: torch.Tensor, speaker: torch.Tensor) -> torch.Tensor:
        """x [B, T, C], speaker [B, spk_dim]."""
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return y * self.W_scale(speaker)[:, None, :] + self.W_bias(speaker)[:, None, :]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Generator(nn.Module):
    def __init__(self, upsample_input: int = 192, upsample_initial_channel: int = 320,
                 upsample_rates=(5, 4, 4, 2, 2), upsample_kernel_sizes=(15, 8, 8, 4, 4),
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3, spk_dim: int = 256,
                 sampling_rate: int = 32000, snake_variant: str = "direct",
                 amp_fused_iter: bool = False, snake_exact_edges: bool = True):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.hop = int(math.prod(upsample_rates))
        self.sampling_rate = sampling_rate
        self.adapter = SpeakerAdapter(spk_dim, upsample_input)
        self.conv_pre = Conv1d(upsample_input, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_in, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(ch_in, ch, k, stride=u, padding=(k - u) // 2))
            if i + 1 < len(upsample_rates):
                stride_f0 = int(math.prod(upsample_rates[i + 1 :]))
                self.noise_convs.append(Conv1d(1, ch, stride_f0 * 2, stride=stride_f0,
                                               padding=stride_f0 // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AMPBlock(ch, rk, tuple(rd), snake_variant, amp_fused_iter,
                                               snake_exact_edges))
        self.activation_post = SnakeAlias(ch, snake_variant, snake_exact_edges)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.adapter.init_weights(generator)
        self.conv_pre.init_weights(generator)
        for up, noise_conv in zip(self.ups, self.noise_convs):
            up.init_weights(generator)
            noise_conv.init_weights(generator)
        for block in self.resblocks:
            block.init_weights(generator)
        self.conv_post.init_weights(generator)

    def forward(self, spk: torch.Tensor, x: torch.Tensor,
                har_source: torch.Tensor | None = None,
                f0_frames: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """har_source, or f0_frames to compute it here (random phases and
        noise from `generator` when train). train=True perturbs the latent."""
        if train:
            x = x + rng.randn(x.shape, generator, device=x.device, dtype=x.dtype)
        x = self.adapter(x, spk)
        x = mish(self.conv_pre(x.transpose(1, 2)))  # [B, C, T]
        if har_source is None:
            har_source = source_hn_nsf(f0_frames, self.hop, self.sampling_rate,
                                       rng=generator if train else None)
        har = har_source.transpose(1, 2).to(x.dtype)  # [B, 1, S]
        nk = self.num_kernels
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(x) + noise_conv(har)
            xs = self.resblocks[i * nk](x)
            for block in self.resblocks[i * nk + 1 : (i + 1) * nk]:
                xs = xs + block(x)
            x = xs / nk
        x = self.conv_post(self.activation_post(x))
        return torch.tanh(x).transpose(1, 2)  # [B, S, 1]
