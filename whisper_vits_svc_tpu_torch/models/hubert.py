"""HuBERT-soft content encoder, 256-d soft units (JAX
whisper_vits_svc_tpu/models/hubert.py; reference bshall hubert-soft,
hubert/hubert_model.py:11-127).

7-conv stride-320 feature extractor (the first conv followed by a
GroupNorm(512, 512), an instance norm over time), LayerNorm + Linear
projection to 768, a weight-normed grouped positional conv (k=128,
groups 16, the norm over dim 2), 12 post-norm transformer layers (768-d,
12 heads, 3072 FFN, exact GELU), a 768 -> 256 projection. `units()` pads
(400 - 320) / 2 on both sides.

Zero-padded rows with real lengths give the real frames of a natural-length
run: the convs are valid, the instance-norm statistics are masked to real
frames, padded frames are zeroed before the positional conv, and attention
keys beyond the real frames are masked. The transformer layer is written
out (not `nn.TransformerEncoderLayer`, whose eval fast path turns padded
inputs into nested tensors) under the reference's key names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import WeightNormed
from ..utils.device import resolve_device
from .convert import torch_load_weights

FE_SPECS = [(512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
            (512, 3, 2), (512, 2, 2), (512, 2, 2)]
PAD = (400 - 320) // 2
# reference keys that only pre-training reads (masking, label prediction)
TRAINING_ONLY_KEYS = ("masked_spec_embed", "label_embedding.weight")


def hubert_num_frames(n_samples: int) -> int:
    """Output frames of `units()` for n_samples of audio: the valid-conv
    arithmetic of the stride-320 stack after the (400 - 320) / 2 pad."""
    n = n_samples + 2 * PAD
    for _, k, s in FE_SPECS:
        n = (n - k) // s + 1
    return n


def masked_instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         frame_mask: torch.Tensor | None = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(C, C) on x [B, C, T]: per-(row, channel) statistics over
    time with biased variance, over the frames of frame_mask [B, T] only
    when it is given."""
    if frame_mask is None:
        mean = x.mean(dim=2, keepdim=True)
        var = (x - mean).square().mean(dim=2, keepdim=True)
    else:
        m = frame_mask[:, None, :].to(x.dtype)
        cnt = m.sum(dim=2, keepdim=True).clamp_min(1.0)
        mean = (x * m).sum(dim=2, keepdim=True) / cnt
        var = ((x - mean).square() * m).sum(dim=2, keepdim=True) / cnt
    return (x - mean) * torch.rsqrt(var + eps) * weight[:, None] + bias[:, None]


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 1
        for i, (ch, k, s) in enumerate(FE_SPECS):
            setattr(self, f"conv{i}", nn.Conv1d(in_ch, ch, k, stride=s, bias=False))
            in_ch = ch
        self.norm0 = nn.GroupNorm(512, 512)

    def forward(self, x: torch.Tensor, n_valid0: torch.Tensor | None = None) -> torch.Tensor:
        """[B, 1, T] audio -> [B, 512, T // 320]. n_valid0 [B]: the real frame
        count at the first conv's output rate."""
        for i in range(len(FE_SPECS)):
            x = getattr(self, f"conv{i}")(x)
            if i == 0:
                mask = None
                if n_valid0 is not None:
                    mask = torch.arange(x.shape[2], device=x.device)[None, :] < n_valid0[:, None]
                x = masked_instance_norm(x, self.norm0.weight, self.norm0.bias, mask)
            x = F.gelu(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.LayerNorm(512, eps=1e-5)
        self.projection = nn.Linear(512, 768)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class _WeightNormConv(WeightNormed):
    """The grouped positional conv's parameters: weight_norm(dim=2) on the
    (O, I/g, K) weight, the norm per kernel position over (O, I/g); it loads
    a folded `weight` too (nn/conv.py::fold_weight_norm)."""

    wn_dim = 2

    def __init__(self, channels: int = 768, kernel_size: int = 128, groups: int = 16):
        super().__init__()
        self.groups, self.kernel_size = groups, kernel_size
        self.weight_norm = True
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size))
        self.weight_v = nn.Parameter(torch.empty(channels, channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight_v, std=0.02)


class PositionalConvEmbedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _WeightNormConv()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, 768] -> [B, T, 768]: the grouped k=128 conv padded 64 each
        side, its last frame dropped, GELU."""
        k = self.conv.kernel_size
        y = F.conv1d(x.transpose(1, 2), self.conv.kernel(), self.conv.bias,
                     padding=k // 2, groups=self.conv.groups)
        return F.gelu(y[:, :, :-1]).transpose(1, 2)


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj),
    computed as two matmuls and a softmax with an optional key mask."""

    def __init__(self, d_model: int = 768, n_heads: int = 12):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.n_heads
        q, k, v = (y.view(b, t, self.n_heads, hd).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        logits = (q / math.sqrt(hd)) @ k.transpose(-1, -2)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], -1e9)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class TransformerLayer(nn.Module):
    """nn.TransformerEncoderLayer(768, 12, 3072, activation="gelu",
    batch_first=True) in eval mode: post-norm."""

    def __init__(self, d_model: int = 768, n_heads: int = 12, d_ff: int = 3072):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, key_mask))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer() for _ in range(n_layers))


class HubertSoft(nn.Module):
    def __init__(self, n_layers: int = 12):
        super().__init__()
        self.feature_extractor = FeatureExtractor()
        self.feature_projection = FeatureProjection()
        self.positional_embedding = PositionalConvEmbedding()
        self.norm = nn.LayerNorm(768, eps=1e-5)
        self.encoder = _Encoder(n_layers)
        self.proj = nn.Linear(768, 256)

    def forward(self, wav: torch.Tensor, n_samples: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T] 16 kHz audio -> [B, T // 320, 256] soft units; with
        n_samples [B], the first hubert_num_frames(n_samples) frames of each
        zero-padded row are those of its natural-length run."""
        x = F.pad(wav, (PAD, PAD))[:, None, :]
        n_valid0 = frame_mask = None
        if n_samples is not None:
            _, k0, s0 = FE_SPECS[0]
            n_valid0 = (n_samples + 2 * PAD - k0) // s0 + 1
            n_final = n_valid0
            for _, k, s in FE_SPECS[1:]:
                n_final = (n_final - k) // s + 1
        x = self.feature_extractor(x, n_valid0).transpose(1, 2)
        x = self.feature_projection(x)
        if n_samples is not None:
            frame_mask = torch.arange(x.shape[1], device=x.device)[None, :] < n_final[:, None]
            x = x * frame_mask[..., None]
        x = self.norm(x + self.positional_embedding(x))
        for layer in self.encoder.layers:
            x = layer(x, frame_mask)
        return self.proj(x)


def load_hubert_soft(ckpt_path: str, device: str | torch.device | None = "cuda") -> HubertSoft:
    """Reference `hubert-soft-0d54a1f4.pt` (a state_dict, keys perhaps under
    "module." or inside "state_dict") -> HubertSoft in eval mode on
    `device` (the card by default)."""
    dev = resolve_device(device)
    sd = torch_load_weights(ckpt_path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v.float() for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if k not in TRAINING_ONLY_KEYS}
    with torch.device("meta"):
        model = HubertSoft(n_layers=len({k.split(".")[2] for k in sd
                                         if k.startswith("encoder.layers.")}))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).eval()


def vec_window_batch(model: HubertSoft, windows: np.ndarray, n_samples: np.ndarray,
                     as_numpy: bool = True) -> np.ndarray | torch.Tensor:
    """[B, win] zero-padded audio rows + [B] real lengths -> [B, frames, 256]
    in one call on the model's device; rows valid to
    hubert_num_frames(n_samples). as_numpy=False returns the device tensor
    without waiting for it (see whisper.ppg_window_batch)."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.as_tensor(windows, dtype=torch.float32).to(dev, non_blocking=True),
                    torch.as_tensor(n_samples, dtype=torch.int64).to(dev, non_blocking=True))
    return out.cpu().numpy() if as_numpy else out


def pred_vec(model: HubertSoft, audio16k: np.ndarray, window_seconds: int = 20) -> np.ndarray:
    """Whole-utterance soft units [frames, 256] in 20 s windows
    (hubert/inference.py:25-50), every window, the zero-padded tail among
    them, in one batched call."""
    win = window_seconds * 16000
    n = len(audio16k)
    # the reference walks `while idx + win < n`: a window starts at every
    # multiple of win below n, so an exact multiple gets a full-window tail
    starts = list(range(0, n, win))
    if not starts:
        return np.zeros((0, 256), np.float32)
    windows = np.zeros((len(starts), win), np.float32)
    lens = np.empty((len(starts),), np.int64)
    for i, s in enumerate(starts):
        seg = audio16k[s : s + win]
        windows[i, : len(seg)] = seg
        lens[i] = len(seg)
    vec = vec_window_batch(model, windows, lens)
    return np.concatenate(
        [vec[i, : hubert_num_frames(int(lens[i]))] for i in range(len(starts))], axis=0)
