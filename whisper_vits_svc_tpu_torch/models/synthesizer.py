"""VITS graphs: prior text encoder, posterior encoder, SNAC flow, NSF-BigVGAN
generator (reference vits/models.py:14-256, JAX models/synthesizer.py).

`SynthesizerInfer` is the inference graph (no posterior). `SynthesizerTrn` is
the training graph: data perturbation, prior and posterior samples, a random
aligned segment slice into the generator, the flow both ways and the GRL
speaker classifier. Every random draw comes from an explicit torch.Generator;
`train=False, perturb=False, noise_scale=0, slice_ids=...` freezes them all.

Public layout: latents [B, T, C], masks [B, T, 1], audio [B, S, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..nn.attention import RelPosTransformer
from ..nn.conv import Conv1d
from ..nn.flow import ResidualCouplingBlock
from ..nn.grl import SpeakerClassifier
from ..nn.wn import WN
from ..utils.pitch import f0_to_coarse
from .generator import Generator


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, T, 1] float mask (reference commons.sequence_mask)."""
    idx = torch.arange(max_length, device=lengths.device)
    return (idx[None, :] < lengths[:, None]).float()[..., None]


def _sample(m: torch.Tensor, logs: torch.Tensor, mask: torch.Tensor, noise_scale: float,
            noise: torch.Tensor | None, generator: torch.Generator | None) -> torch.Tensor:
    """(m + noise * e^logs * noise_scale) * mask; noise drawn from `generator`
    when not given, and not at all when noise_scale == 0."""
    if noise_scale == 0:
        return m * mask
    if noise is None:
        noise = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
    return (m + noise * torch.exp(logs) * noise_scale) * mask


class TextEncoder(nn.Module):
    """PPG + content-vec + quantized-F0 prior encoder (vits/models.py:14-52)."""

    def __init__(self, in_channels: int = 1280, vec_channels: int = 256,
                 out_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 640, n_heads: int = 2, n_layers: int = 6,
                 kernel_size: int = 3, p_dropout: float = 0.1):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 5, padding=2)
        self.hub = Conv1d(vec_channels, hidden_channels, 5, padding=2)
        self.pit = nn.Embedding(256, hidden_channels)
        self.enc = RelPosTransformer(hidden_channels, filter_channels, n_heads, n_layers,
                                     kernel_size, p_dropout=p_dropout)
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
                generator: torch.Generator | None = None, train: bool = False):
        """ppg [B,T,ppg_dim], vec [B,T,vec_dim], f0_coarse [B,T] int ->
        (z, m, logs, mask, x). noise [B,T,out] is drawn from `generator` when
        not given (and not drawn at all when noise_scale == 0); train=True
        turns the transformer's dropout on, its masks from `generator`."""
        x_mask = sequence_mask(lengths, ppg.shape[1]).to(ppg.dtype)
        x = self.pre.forward_ntc(ppg) * x_mask
        v = self.hub.forward_ntc(vec) * x_mask
        x = x + v + self.pit(f0_coarse)
        x = self.enc(x * x_mask, x_mask, train, generator)
        stats = self.proj.forward_ntc(x) * x_mask
        m, logs = stats[..., : self.out_channels], stats[..., self.out_channels :]
        z = _sample(m, logs, x_mask, noise_scale, noise, generator)
        return z, m, logs, x_mask, x


class PosteriorEncoder(nn.Module):
    """Linear-spectrogram posterior: 1x1 pre, gin-conditioned WN, 1x1 proj to
    (m, logs) (vits/models.py:101-136, JAX models/synthesizer.py:71-94)."""

    def __init__(self, in_channels: int, out_channels: int = 192, hidden_channels: int = 192,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 256):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        self.pre.init_weights(generator)
        self.enc.init_weights(generator)
        self.proj.init_weights(generator)

    def forward(self, spec: torch.Tensor, lengths: torch.Tensor, g: torch.Tensor,
                noise_scale: float = 1.0, generator: torch.Generator | None = None):
        """spec [B,T,bins], g [B,gin] -> (z, m, logs, mask)."""
        x_mask = sequence_mask(lengths, spec.shape[1]).to(spec.dtype)
        x = self.pre.forward_ntc(spec) * x_mask
        x = self.enc(x, x_mask, g=g[:, None, :])
        stats = self.proj.forward_ntc(x) * x_mask
        m, logs = stats[..., : self.out_channels], stats[..., self.out_channels :]
        return _sample(m, logs, x_mask, noise_scale, None, generator), m, logs, x_mask


def slice_segments(x: torch.Tensor, ids: torch.Tensor, segment_size: int) -> torch.Tensor:
    """[B, T, ...] -> [B, segment_size, ...] from per-item offsets
    (commons.py:74-81); a start past T - segment_size is clamped back, as
    JAX's dynamic_slice clamps it."""
    t = x.shape[1]
    start = ids.long().clamp(0, t - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


def rand_slice_segments_with_pitch(z: torch.Tensor, pitch: torch.Tensor,
                                   lengths: torch.Tensor, segment_size: int,
                                   ids: torch.Tensor | None = None,
                                   generator: torch.Generator | None = None):
    """Random aligned (z, pitch) slice per batch item (commons.py:8-26):
    offsets uniform in [0, length - segment_size] unless `ids` gives them.
    Returns (z [B, seg, C], pitch [B, seg], ids [B])."""
    if ids is None:
        ids_str_max = (lengths - segment_size + 1).float()
        u = torch.rand(z.shape[0], generator=generator, device=z.device)
        ids = (u * ids_str_max).long()
    return slice_segments(z, ids, segment_size), slice_segments(pitch, ids, segment_size), ids


class TrainOutputs(NamedTuple):
    fake_audio: torch.Tensor    # [B, segment*hop, 1]
    ids_slice: torch.Tensor     # [B]
    spec_mask: torch.Tensor     # [B, T, 1]
    z_f: torch.Tensor
    z_r: torch.Tensor
    z_p: torch.Tensor
    m_p: torch.Tensor
    logs_p: torch.Tensor
    z_q: torch.Tensor
    m_q: torch.Tensor
    logs_q: torch.Tensor
    logdet_f: torch.Tensor
    logdet_r: torch.Tensor
    spk_preds: torch.Tensor


class SynthesizerTrn(nn.Module):
    """Training graph (reference vits/models.py:139-208, JAX
    models/synthesizer.py:144-245)."""

    def __init__(self, spec_channels: int = 513, segment_size: int = 25, ppg_dim: int = 1280,
                 vec_dim: int = 256, spk_dim: int = 256, gin_channels: int = 256,
                 inter_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 640, upsample_rates=(5, 4, 4, 2, 2),
                 upsample_kernel_sizes=(15, 8, 8, 4, 4), upsample_initial_channel: int = 320,
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3, sampling_rate: int = 32000,
                 enc_p_layers: int = 6, enc_q_layers: int = 16, flow_wn_layers: int = 4,
                 n_flows: int = 4):
        super().__init__()
        self.segment_size = segment_size
        self.emb_g = nn.Linear(spk_dim, gin_channels)
        self.enc_p = TextEncoder(ppg_dim, vec_dim, inter_channels, hidden_channels,
                                 filter_channels, 2, enc_p_layers, 3, 0.1)
        self.speaker_classifier = SpeakerClassifier(hidden_channels, spk_dim)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1,
                                      enc_q_layers, gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1,
                                          flow_wn_layers, n_flows=n_flows,
                                          gin_channels=spk_dim)
        self.dec = Generator(inter_channels, upsample_initial_channel, upsample_rates,
                             upsample_kernel_sizes, resblock_kernel_sizes,
                             resblock_dilation_sizes, spk_dim, sampling_rate)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights with the JAX package's initializers (torch's
        defaults: U(-b, b), b = 1/sqrt(fan_in))."""
        bound = self.emb_g.in_features ** -0.5
        with torch.no_grad():
            self.emb_g.weight.uniform_(-bound, bound, generator=generator)
            self.emb_g.bias.uniform_(-bound, bound, generator=generator)
        self.enc_p.init_weights(generator)
        self.speaker_classifier.init_weights(generator)
        self.enc_q.init_weights(generator)
        self.flow.init_weights(generator)
        self.dec.init_weights(generator)

    def forward(self, ppg: torch.Tensor, vec: torch.Tensor, pit: torch.Tensor,
                spec: torch.Tensor, spk: torch.Tensor, ppg_l: torch.Tensor,
                spec_l: torch.Tensor, train: bool = True, perturb: bool = True,
                noise_scale: float = 1.0, slice_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> TrainOutputs:
        """The GAN generator forward (models.py:183-200); pit [B, T] Hz,
        spec [B, T, bins]. Random draws come from `generator` (on the
        inputs' device)."""

        def randn(x):
            return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

        if perturb:  # data perturbation (models.py:184-185)
            ppg = ppg + randn(ppg)
            vec = vec + randn(vec) * 2.0
        spk_n = spk / torch.linalg.vector_norm(spk, dim=-1, keepdim=True).clamp_min(1e-12)
        g = self.emb_g(spk_n)
        z_p, m_p, logs_p, _, x = self.enc_p(ppg, ppg_l, vec, f0_to_coarse(pit), noise_scale,
                                            generator=generator, train=train)
        z_q, m_q, logs_q, spec_mask = self.enc_q(spec, spec_l, g, noise_scale, generator)
        z_slice, pit_slice, ids_slice = rand_slice_segments_with_pitch(
            z_q, pit, spec_l, self.segment_size, ids=slice_ids, generator=generator)
        audio = self.dec(spk, z_slice, f0_frames=pit_slice, train=train, generator=generator)
        z_f, logdet_f = self.flow(z_q, spec_mask, g=spk)
        z_r, logdet_r = self.flow(z_p, spec_mask, g=spk, reverse=True)
        spk_preds = self.speaker_classifier(x)
        return TrainOutputs(audio, ids_slice, spec_mask, z_f, z_r, z_p, m_p, logs_p,
                            z_q, m_q, logs_q, logdet_f, logdet_r, spk_preds)


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
                             resblock_dilation_sizes, spk_dim, sampling_rate)

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
