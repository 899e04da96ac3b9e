"""Silero VAD (v3, "VADr_v3_medium_conc") as an nn.Module (JAX
whisper_vits_svc_tpu/models/silero_vad.py; the reference post filter runs
the TorchScript blob vad/assets/silero_vad.jit, vad/utils.py:146, 263-268).

The network, batched over every 512-sample window of a 16 kHz input:

    STFT (n_fft 256, hop 64, reflect pad 96) as one product with the
        blob's [258, 256] basis                        -> magnitude [129, F]
    adaptive normalization: log1p(mag * 2^20) minus the time mean of a
        7-tap-smoothed channel mean                    -> [129, F]
    concat(mag, norm)                                  -> [258, F]
    ConvBlock (depthwise k5 p2, ReLU, pointwise 1x1, residual projection)
    3 x [1x1 stride-2 conv, folded BatchNorm, ReLU, ConvBlock]
    1x1 conv, folded BatchNorm, ReLU                   -> [64, F/8]
    2-layer LSTM(64) carried across windows, ReLU, 1x1 conv, sigmoid
    mean over each window's frames                     -> one probability

A 512-sample window gives 8 STFT frames and 1 after the three stride-2
stages, so the LSTM advances one step per window, as the reference's
stateful chunk loop does; here it is one nn.LSTM call over the utterance.
`load_silero_vad` reads the blob with torch.jit.load and folds the
BatchNorms (scale = w / sqrt(var + eps), bias = b - mean * scale); the
LSTM keeps the blob's bias_ih and bias_hh (the JAX package sums them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

N_FFT, HOP = 256, 64
PAD = (N_FFT - HOP) // 2


class ConvBlock(nn.Module):
    """Depthwise k5 -> ReLU -> pointwise, plus the input (projected where
    `proj`), then ReLU."""

    def __init__(self, c_in: int, c_out: int, proj: bool):
        super().__init__()
        self.dw_conv = nn.Conv1d(c_in, c_in, 5, padding=2, groups=c_in)
        self.pw_conv = nn.Conv1d(c_in, c_out, 1)
        self.proj = nn.Conv1d(c_in, c_out, 1) if proj else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pw_conv(F.relu(self.dw_conv(x)))
        return F.relu(h + (self.proj(x) if self.proj is not None else x))


class ConvBN(nn.Module):
    """1x1 conv then the folded BatchNorm and ReLU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, 1)
        self.register_buffer("bn_scale", torch.ones(c_out))
        self.register_buffer("bn_bias", torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x) * self.bn_scale[:, None] + self.bn_bias[:, None])


class EncoderStage(nn.Module):
    """Stride-2 1x1 conv, folded BatchNorm, ReLU, ConvBlock."""

    def __init__(self, c_in: int, c_out: int, proj: bool):
        super().__init__()
        self.down = ConvBN(c_in, c_out)
        self.block = ConvBlock(c_out, c_out, proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(self.down(x[:, :, ::2]))


class SileroVAD(nn.Module):
    """widths: the first block's output and the three stages' widths;
    projs: whether the first block and each stage's block project their
    residual."""

    def __init__(self, widths=(16, 32, 32, 64), hidden: int = 64,
                 projs=(True, False, False, False)):
        super().__init__()
        n_bins = N_FFT // 2 + 1
        self.register_buffer("stft_basis", torch.zeros(2 * n_bins, N_FFT))
        self.register_buffer("an_filter", torch.zeros(7))
        self.first = ConvBlock(2 * n_bins, widths[0], projs[0])
        self.encoder = nn.ModuleList(EncoderStage(a, b, p) for a, b, p
                                     in zip(widths[:-1], widths[1:], projs[1:]))
        self.enc_post = ConvBN(widths[-1], hidden)
        self.rnn = nn.LSTM(hidden, hidden, num_layers=2)
        self.decoder = nn.Conv1d(hidden, 1, 1)

    def forward(self, chunks: torch.Tensor) -> torch.Tensor:
        """chunks [N, window] -> speech probability per chunk [N], the LSTM
        state carried from chunk to chunk."""
        n_bins = N_FFT // 2 + 1
        x = F.pad(chunks[:, None], (PAD, PAD), mode="reflect")[:, 0]
        spec = (x.unfold(-1, N_FFT, HOP) @ self.stft_basis.t()).transpose(1, 2)  # [N, 258, F]
        re, im = spec[:, :n_bins], spec[:, n_bins:]
        mag = torch.sqrt(re * re + im * im)
        # adaptive normalization (AdaptiveAudioNormalizationNew)
        spect = torch.log1p(mag * 1048576.0)
        mean = spect.mean(dim=1)  # [N, F]
        mean = torch.cat([mean[:, 1:4].flip(1), mean, mean[:, -4:-1].flip(1)], dim=1)
        n_frames = spect.shape[-1]
        smooth = sum(self.an_filter[j] * mean[:, j : j + n_frames] for j in range(7))
        norm = spect - smooth.mean(dim=-1)[:, None, None]
        h = self.first(torch.cat([mag, norm], dim=1))
        for stage in self.encoder:
            h = stage(h)
        h = self.enc_post(h)
        # [N, 64, T'] -> one sequence of N * T' steps (T' = 1 for 512-sample
        # windows), so that the state flows across chunks
        feats = h.transpose(1, 2).reshape(-1, 1, h.shape[1])
        ys, _ = self.rnn(feats)
        logits = self.decoder(F.relu(ys[:, 0])[..., None])[:, 0, 0]
        return torch.sigmoid(logits).reshape(chunks.shape[0], -1).mean(dim=1)


def _fold_bn(bn) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return scale, bn.bias - bn.running_mean * scale


def _block_sd(sd: dict, name: str, blk) -> None:
    dw = list(blk.dw_conv.children())[0]
    pw = list(blk.pw_conv.children())[0]
    sd[f"{name}.dw_conv.weight"], sd[f"{name}.dw_conv.bias"] = dw.weight, dw.bias
    sd[f"{name}.pw_conv.weight"], sd[f"{name}.pw_conv.bias"] = pw.weight, pw.bias
    proj = getattr(blk, "proj", None)
    if proj is not None:
        sd[f"{name}.proj.weight"], sd[f"{name}.proj.bias"] = proj.weight, proj.bias


def build_silero_vad(sd: dict, device: str | torch.device | None = "cuda") -> SileroVAD:
    """A SileroVAD whose widths and residual projections are read from the
    state_dict `sd`, with its weights, in eval mode on `device`."""
    blocks = ["first"] + [f"encoder.{i}.block" for i in range(3)]
    projs = tuple(f"{b}.proj.weight" in sd for b in blocks)
    widths = [sd["first.pw_conv.weight"].shape[0]]
    widths += [sd[f"encoder.{i}.down.conv.weight"].shape[0] for i in range(3)]
    model = SileroVAD(tuple(widths), sd["enc_post.conv.weight"].shape[0], projs)
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()}, strict=True)
    return model.to(resolve_device(device)).eval()


def load_silero_vad(path: str = "vad/assets/silero_vad.jit",
                    device: str | torch.device | None = "cuda") -> SileroVAD:
    """The TorchScript blob (its 16 kHz branch `_model`) -> SileroVAD on
    `device`, reading the attributes the JAX package's loader reads."""
    net = torch.jit.load(path, map_location="cpu")._model
    enc = list(net.encoder.children())
    sd = {"stft_basis": net.feature_extractor.forward_basis_buffer[:, 0, :],
          "an_filter": net.adaptive_normalization.filter_[0, 0]}
    _block_sd(sd, "first", list(net.first_layer.children())[0])
    for i, (conv_i, bn_i, blk_i) in enumerate([(0, 1, 3), (4, 5, 7), (8, 9, 11)]):
        sd[f"encoder.{i}.down.conv.weight"] = enc[conv_i].weight
        sd[f"encoder.{i}.down.conv.bias"] = enc[conv_i].bias
        sd[f"encoder.{i}.down.bn_scale"], sd[f"encoder.{i}.down.bn_bias"] = _fold_bn(enc[bn_i])
        _block_sd(sd, f"encoder.{i}.block", list(enc[blk_i].children())[0])
    sd["enc_post.conv.weight"], sd["enc_post.conv.bias"] = enc[12].weight, enc[12].bias
    sd["enc_post.bn_scale"], sd["enc_post.bn_bias"] = _fold_bn(enc[13])
    rnn = net.decoder.rnn
    for layer in (0, 1):
        for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"rnn.{kind}_l{layer}"] = getattr(rnn, f"{kind}_l{layer}")
    dec = list(net.decoder.decoder.children())[1]
    sd["decoder.weight"], sd["decoder.bias"] = dec.weight, dec.bias
    return build_silero_vad({k: v.detach() for k, v in sd.items()}, device)


def silero_speech_probs(model: SileroVAD, audio: np.ndarray,
                        window_size_samples: int = 512) -> np.ndarray:
    """Per-window speech probabilities of 16 kHz audio (vad/utils.py:263-268:
    the trailing partial window zero-padded, a fresh LSTM state per
    utterance), on the model's device."""
    audio = np.asarray(audio, np.float32)
    n_win = -(-len(audio) // window_size_samples)
    padded = np.zeros(n_win * window_size_samples, np.float32)
    padded[: len(audio)] = audio
    chunks = torch.from_numpy(padded.reshape(n_win, window_size_samples))
    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(chunks.to(dev)).cpu().numpy()
