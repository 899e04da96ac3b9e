"""The so-vits-svc 5.0 synthesizer in plain PyTorch (vits/models.py,
vits_decoder/generator.py), frozen as the benchmark's reference: the
inference graph (`SynthesizerInfer`) and the training graph with its random
draws (`SynthesizerTrn`). Layout is torch's [B, C, T] inside; the public
calls take features [B, T, C] and return audio [B, S, 1], as the program's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (AMPBlock, Activation, Conv1d, ConvTranspose1d, Encoder, Flow,
                     GradReverse, WN, excitation, f0_to_coarse, randn_ntc)


def seq_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B] -> [B, 1, T] float."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()[:, None]


class TextEncoder(nn.Module):
    def __init__(self, ppg_dim, vec_dim, out, hidden, filters, n_layers, p_dropout=0.1):
        super().__init__()
        self.out = out
        self.pre = Conv1d(ppg_dim, hidden, 5, padding=2)
        self.hub = Conv1d(vec_dim, hidden, 5, padding=2)
        self.pit = nn.Embedding(256, hidden)
        self.enc = Encoder(hidden, filters, 2, n_layers, 3, p_dropout)
        self.proj = Conv1d(hidden, 2 * out, 1)

    def forward(self, ppg, lengths, vec, pit, noise_scale, noise=None, generator=None,
                train=False):
        mask = seq_mask(lengths, ppg.shape[1])
        x = self.pre(ppg.transpose(1, 2)) * mask
        x = x + self.hub(vec.transpose(1, 2)) * mask + self.pit(f0_to_coarse(pit)).transpose(1, 2)
        x = self.enc(x * mask, mask, train, generator)
        stats = self.proj(x) * mask
        m, logs = stats[:, : self.out], stats[:, self.out :]
        if noise_scale == 0:
            return m * mask, m, logs, mask, x
        if noise is None:
            noise = randn_ntc(m, generator)
        return (m + noise * torch.exp(logs) * noise_scale) * mask, m, logs, mask, x


class Posterior(nn.Module):
    def __init__(self, spec_dim, out, hidden, n_layers, gin):
        super().__init__()
        self.out = out
        self.pre = Conv1d(spec_dim, hidden, 1)
        self.enc = WN(hidden, 5, n_layers, gin)
        self.proj = Conv1d(hidden, 2 * out, 1)

    def forward(self, spec, lengths, g, generator):
        mask = seq_mask(lengths, spec.shape[1])
        x = self.enc(self.pre(spec.transpose(1, 2)) * mask, mask, g[:, :, None])
        stats = self.proj(x) * mask
        m, logs = stats[:, : self.out], stats[:, self.out :]
        z = (m + randn_ntc(m, generator) * torch.exp(logs)) * mask
        return z, m, logs, mask


class SpeakerAdapter(nn.Module):
    def __init__(self, spk_dim, channels):
        super().__init__()
        self.W_scale = nn.Linear(spk_dim, channels)
        self.W_bias = nn.Linear(spk_dim, channels)

    def forward(self, x, spk):  # x [B, C, T]
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + 1e-5)
        return y * self.W_scale(spk)[:, :, None] + self.W_bias(spk)[:, :, None]


class Generator(nn.Module):
    """NSF-BigVGAN: adapter, Mish pre-conv, five weight-norm transposed
    convolutions each followed by the excitation through a strided noise
    convolution and the mean of three AMP blocks, then snake, conv, tanh."""

    def __init__(self, hp):
        super().__init__()
        g = hp["gen"]
        rates, ks = g["upsample_rates"], g["upsample_kernel_sizes"]
        self.hop, self.sr = math.prod(rates), hp["data"]["sampling_rate"]
        self.nk = len(g["resblock_kernel_sizes"])
        ch0 = g["upsample_initial_channel"]
        inter = hp["vits"]["inter_channels"]
        self.adapter = SpeakerAdapter(hp["vits"]["spk_dim"], inter)
        self.conv_pre = Conv1d(inter, ch0, 7, padding=3)
        self.ups, self.noise_convs, self.resblocks = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        ch = ch0
        for i, (u, k) in enumerate(zip(rates, ks)):
            ch_in, ch = ch, ch0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(ch_in, ch, k, u, (k - u) // 2))
            if i + 1 < len(rates):
                s = math.prod(rates[i + 1 :])
                self.noise_convs.append(Conv1d(1, ch, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1))
            for rk, rd in zip(g["resblock_kernel_sizes"], g["resblock_dilation_sizes"]):
                self.resblocks.append(AMPBlock(ch, rk, tuple(rd)))
        self.activation_post = Activation(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, spk, x, source=None, f0=None, train=False, generator=None):
        """x [B, C, T] latent; source [B, T*hop, 1], or f0 [B, T] to make it
        here (random phases and noise when training)."""
        if train:
            x = x + randn_ntc(x, generator)
        x = self.adapter(x, spk)
        x = self.conv_pre(x)
        x = x * torch.tanh(F.softplus(x))
        if source is None:
            source = excitation(f0, self.hop, self.sr, generator if train else None)
        har = source.transpose(1, 2)
        for i, (up, nc) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(x) + nc(har)
            xs = self.resblocks[i * self.nk](x)
            for block in self.resblocks[i * self.nk + 1 : (i + 1) * self.nk]:
                xs = xs + block(x)
            x = xs / self.nk
        return torch.tanh(self.conv_post(self.activation_post(x))).transpose(1, 2)


def _flow(hp):
    v = hp["vits"]
    return Flow(v["inter_channels"], v["hidden_channels"], 5, v.get("flow_wn_layers", 4),
                v.get("n_flows", 4), v["spk_dim"])


def _text_encoder(hp):
    v = hp["vits"]
    return TextEncoder(v["ppg_dim"], v["vec_dim"], v["inter_channels"], v["hidden_channels"],
                       v["filter_channels"], v.get("enc_p_layers", 6))


class SynthesizerInfer(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.hop = math.prod(hp["gen"]["upsample_rates"])
        self.sr = hp["data"]["sampling_rate"]
        self.inter = hp["vits"]["inter_channels"]
        self.enc_p = _text_encoder(hp)
        self.flow = _flow(hp)
        self.dec = Generator(hp)

    def forward(self, ppg, vec, pit, spk, lengths, source, noise_scale, noise=None):
        """ppg/vec [B, T, C], pit [B, T] Hz, source [B, T*hop, 1], noise
        [B, T, inter] -> audio [B, T*hop, 1]."""
        if noise is not None:
            noise = noise.transpose(1, 2)
        z, _, _, mask, _ = self.enc_p(ppg, lengths, vec, pit, noise_scale, noise)
        z, _ = self.flow(z, mask, spk, reverse=True)
        return self.dec(spk, z * mask, source=source)


class SpeakerClassifier(nn.Module):
    def __init__(self, hidden, spk_dim):
        super().__init__()
        self.classifier = nn.ModuleList([
            nn.Identity(), Conv1d(hidden, hidden, 5, padding=2, wn=True), nn.Identity(),
            Conv1d(hidden, hidden, 5, padding=2, wn=True), nn.Identity(),
            Conv1d(hidden, spk_dim, 5, padding=2, wn=True)])

    def forward(self, x):
        c = self.classifier
        x = torch.relu(c[1](GradReverse.apply(x)))
        x = torch.relu(c[3](x))
        return c[5](x).mean(dim=2)


class SynthesizerTrn(nn.Module):
    """The training graph (vits/models.py SynthesizerTrn.forward)."""

    def __init__(self, hp):
        super().__init__()
        v, d = hp["vits"], hp["data"]
        self.hop = d["hop_length"]
        self.segment = d["segment_size"] // d["hop_length"]
        self.emb_g = nn.Linear(v["spk_dim"], v["gin_channels"])
        self.enc_p = _text_encoder(hp)
        self.speaker_classifier = SpeakerClassifier(v["hidden_channels"], v["spk_dim"])
        self.enc_q = Posterior(d["filter_length"] // 2 + 1, v["inter_channels"],
                               v["hidden_channels"], v.get("enc_q_layers", 16), v["gin_channels"])
        self.flow = _flow(hp)
        self.dec = Generator(hp)

    def forward(self, ppg, vec, pit, spec, spk, ppg_l, spec_l, generator):
        """Random draws in the graph's order: the PPG and unit perturbation,
        the prior encoder's dropout and sample, the posterior sample, the
        segment offsets, the latent perturbation, the excitation's phases
        and noise."""
        ppg = ppg + torch.randn(ppg.shape, generator=generator, device=ppg.device)
        vec = vec + torch.randn(vec.shape, generator=generator, device=vec.device) * 2.0
        spk_n = spk / torch.linalg.vector_norm(spk, dim=-1, keepdim=True).clamp_min(1e-12)
        g = self.emb_g(spk_n)
        z_p, m_p, logs_p, _, x = self.enc_p(ppg, ppg_l, vec, pit, 1.0, generator=generator,
                                            train=True)
        z_q, m_q, logs_q, mask = self.enc_q(spec, spec_l, g, generator)
        b, t = z_q.shape[0], z_q.shape[2]
        ids = (torch.rand((b,), generator=generator, device=z_q.device)
               if z_q.device.type != "meta" else torch.rand((b,), device="meta"))
        ids = (ids * (spec_l - self.segment + 1).float()).long().clamp(0, t - self.segment)
        idx = ids[:, None] + torch.arange(self.segment, device=z_q.device)[None, :]
        z_slice = torch.gather(z_q, 2, idx[:, None, :].expand(-1, z_q.shape[1], -1))
        pit_slice = torch.gather(pit, 1, idx)
        audio = self.dec(spk, z_slice, f0=pit_slice, train=True, generator=generator)
        z_f, logdet_f = self.flow(z_q, mask, spk)
        z_r, logdet_r = self.flow(z_p, mask, spk, reverse=True)
        spk_preds = self.speaker_classifier(x)
        return dict(audio=audio, ids=ids, mask=mask, z_f=z_f, z_r=z_r, m_p=m_p, logs_p=logs_p,
                    m_q=m_q, logs_q=logs_q, logdet_f=logdet_f, logdet_r=logdet_r,
                    spk_preds=spk_preds)
