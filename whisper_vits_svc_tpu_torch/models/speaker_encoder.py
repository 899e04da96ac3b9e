"""LSTM d-vector speaker encoder and its mozilla-TTS audio frontend (JAX
whisper_vits_svc_tpu/models/speaker_encoder.py; reference
speaker/models/lstm.py:8-101, speaker/utils/audio.py, config
speaker_pretrain/config.json).

3 x (LSTM-768 -> Linear-256 without bias), the last frame L2-normalised;
`compute_embedding` averages 10 sliding 250-frame windows.
`ResNetSpeakerEncoder` is the reference's alternative H/ASP SE-ResNet
d-vector, which nothing calls. The LSTM is
`nn.LSTM` (gate order i, f, g, o, the JAX scan's); with `lengths`, the
state at each row's last real frame is taken, so right-zero-padded rows
give their natural-length d-vectors (the LSTM is causal).

Frontend, numpy on the host: 16 kHz, preemphasis 0.98, STFT (1024 / 256 /
1024, center, reflect), slaney mel 80 (0-8000 Hz), 20 log10 dB, symmetric
[-4, 4] normalisation, and a -60 dB silence trim (audio.py:561-714).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import lfilter
from torch import nn

from ..ops.mel import mel_filterbank
from ..ops.stft import _windowed_dft
from ..utils.device import resolve_device
from .convert import torch_load_weights


class LSTMWithProjection(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True)
        self.linear = nn.Linear(hidden_size, proj_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.lstm(x)[0])


class LSTMSpeakerEncoder(nn.Module):
    def __init__(self, input_dim: int = 80, proj_dim: int = 256, lstm_dim: int = 768,
                 num_layers: int = 3):
        super().__init__()
        self.layers = nn.Sequential(*(
            LSTMWithProjection(input_dim if i == 0 else proj_dim, lstm_dim, proj_dim)
            for i in range(num_layers)))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T, 80] mel -> [B, proj_dim] L2-normalised d-vector of the last
        frame, or of frame lengths[i] - 1 of row i."""
        x = self.layers(x)
        if lengths is None:
            d = x[:, -1]
        else:
            d = x[torch.arange(x.shape[0], device=x.device), lengths - 1]
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


def load_speaker_encoder(ckpt_path: str, device: str | torch.device | None = "cuda"
                         ) -> LSTMSpeakerEncoder:
    """Reference `best_model.pth.tar` ({"model": state_dict, ...}, or a bare
    state_dict) -> the encoder in eval mode on `device` (the card by
    default)."""
    dev = resolve_device(device)
    ckpt = torch_load_weights(ckpt_path)
    sd = ckpt.get("model", ckpt)
    w_ih = sd["layers.0.lstm.weight_ih_l0"]
    model = LSTMSpeakerEncoder(input_dim=w_ih.shape[1], lstm_dim=w_ih.shape[0] // 4,
                               proj_dim=sd["layers.0.linear.weight"].shape[0],
                               num_layers=len({k.split(".")[1] for k in sd
                                               if k.startswith("layers.")}))
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


# ------------------------------------------------------- ResNet alternative


class SELayer(nn.Module):
    """Squeeze-excite gate (reference speaker/models/resnet.py:8-23)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction), nn.ReLU(),
                                nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """Squeeze-excite ResNet block (reference speaker/models/resnet.py:26-56),
    in the JAX package's order: conv, ReLU, BN, conv, BN, SE, + residual,
    ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 reduction: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SELayer(planes, reduction)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride,
                                                   bias=False), nn.BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(F.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetSpeakerEncoder(nn.Module):
    """H/ASP SE-ResNet d-vector (reference speaker/models/resnet.py:59-180; JAX
    whisper_vits_svc_tpu/models/speaker_encoder.py:156-220), the alternative
    encoder, unused by the default pipeline there: kept for parity. Input
    [B, T, input_dim] mel; output [B, proj_dim]. The BatchNorms run in eval
    mode (running statistics), as the JAX package's folded affine does."""

    def __init__(self, input_dim: int = 64, proj_dim: int = 512,
                 layers: tuple[int, ...] = (3, 4, 6, 3),
                 num_filters: tuple[int, ...] = (32, 64, 128, 256),
                 encoder_type: str = "ASP", log_input: bool = False):
        super().__init__()
        assert encoder_type in ("SAP", "ASP"), encoder_type
        self.encoder_type = encoder_type
        self.log_input = log_input
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(num_filters[0])
        inplanes = num_filters[0]
        for li, (blocks, planes) in enumerate(zip(layers, num_filters)):
            stride = 1 if li == 0 else 2
            down = stride != 1 or inplanes != planes
            self.add_module(f"layer{li + 1}", nn.Sequential(*(
                SEBasicBlock(inplanes if bi == 0 else planes, planes,
                             stride if bi == 0 else 1, down and bi == 0)
                for bi in range(blocks))))
            inplanes = planes
        self.n_layers = len(layers)
        feat = num_filters[-1] * (-(-input_dim // 2 ** (len(layers) - 1)))
        self.attention = nn.Sequential(nn.Conv1d(feat, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
                                       nn.Conv1d(128, feat, 1), nn.Softmax(dim=2))
        self.fc = nn.Linear(feat * (2 if encoder_type == "ASP" else 1), proj_dim)

    def forward(self, x: torch.Tensor, l2_norm: bool = False) -> torch.Tensor:
        if self.log_input:
            x = torch.log(x + 1e-6)
        # instance norm over time per mel bin (torch InstanceNorm1d on [B, D, T])
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5)
        h = self.bn1(F.relu(self.conv1(x.transpose(1, 2)[:, None])))  # [B, 1, D, T]
        for li in range(self.n_layers):
            h = getattr(self, f"layer{li + 1}")(h)
        feat = h.reshape(h.shape[0], -1, h.shape[-1])  # [B, C * D', T']
        w = self.attention(feat)
        mu = torch.sum(feat * w, dim=2)
        if self.encoder_type == "SAP":
            pooled = mu
        else:
            var = torch.sum(feat.square() * w, dim=2) - mu.square()
            sg = torch.sqrt(torch.clamp(var, min=1e-5))
            pooled = torch.cat([mu, sg], dim=1)
        out = self.fc(pooled)
        if l2_norm:
            out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
        return out


# ---------------------------------------------------------------- frontend

SR = 16000
N_FFT = 1024
HOP = 256
WIN = 1024
N_MELS = 80
PREEMPHASIS = 0.98
REF_DB = 20.0
MIN_DB = -100.0
MAX_NORM = 4.0
TRIM_DB = 60.0


def trim_silence(audio: np.ndarray, top_db: float = TRIM_DB,
                 frame_length: int = WIN, hop_length: int = HOP) -> np.ndarray:
    """librosa.effects.trim equivalent (audio.py:714)."""
    n = 1 + max(len(audio) - frame_length, 0) // hop_length
    if n == 0:
        return audio
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(np.square(audio[idx]), axis=1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if len(keep) == 0:
        return audio[:0]
    start = int(keep[0] * hop_length)
    end = min(len(audio), int((keep[-1] + 1) * hop_length + frame_length))
    return audio[start:end]


def speaker_melspectrogram(audio: np.ndarray) -> np.ndarray:
    """[T] 16 kHz float audio -> [frames, 80] normalised mel (audio.py:561-570)."""
    emph = lfilter([1.0, -PREEMPHASIS], [1.0], audio).astype(np.float32)
    pad = N_FFT // 2
    y = np.pad(emph, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    spec = y[idx] @ _windowed_dft(N_FFT, WIN, "hann")
    n_bins = N_FFT // 2 + 1
    mag = np.sqrt(spec[:, :n_bins] ** 2 + spec[:, n_bins:] ** 2)
    mel = mag @ mel_filterbank(SR, N_FFT, N_MELS, 0.0, 8000.0).T
    db = REF_DB * np.log10(np.maximum(1e-5, mel)) - REF_DB
    norm = (db - MIN_DB) / (-MIN_DB) * 2.0 * MAX_NORM - MAX_NORM
    return np.clip(norm, -MAX_NORM, MAX_NORM).astype(np.float32)


def embed_windows(model: LSTMSpeakerEncoder, batch: np.ndarray, n_utts: int,
                  lengths: np.ndarray | None = None,
                  as_numpy: bool = True) -> np.ndarray | torch.Tensor:
    """[n_utts * 10, nf, 80] mel windows of many utterances -> [n_utts, d]:
    each utterance's mean over its 10 window d-vectors, on the model's
    device. lengths [n_utts * 10] marks the real frames of right-zero-padded
    rows (the JAX package's _spk_batch_program). as_numpy=False returns the
    device tensor without waiting for it (see whisper.ppg_window_batch)."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        emb = model(torch.as_tensor(batch, dtype=torch.float32).to(dev, non_blocking=True),
                    None if lengths is None
                    else torch.as_tensor(lengths, dtype=torch.int64).to(dev, non_blocking=True))
        out = emb.reshape(n_utts, -1, emb.shape[-1]).mean(dim=1)
    return out.cpu().numpy() if as_numpy else out


def compute_embedding(model: LSTMSpeakerEncoder, audio16k: np.ndarray, num_frames: int = 250,
                      num_eval: int = 10, trim: bool = True) -> np.ndarray:
    """Utterance -> d-vector, the mean of 10 sliding windows (lstm.py:76-101)."""
    if trim:
        audio16k = trim_silence(audio16k)
    mel = speaker_melspectrogram(audio16k)
    max_len = mel.shape[0]
    nf = min(num_frames, max_len)
    offsets = np.linspace(0, max_len - nf, num=num_eval).astype(int)
    return embed_windows(model, np.stack([mel[o : o + nf] for o in offsets]), 1)[0]
