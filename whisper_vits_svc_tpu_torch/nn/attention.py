"""Relative-position transformer encoder (the VITS prior-encoder trunk).

Semantics of the reference Encoder / MultiHeadAttention / FFN
(vits/attentions.py): learned relative key/value embeddings over a +-4
window shared across heads, masked softmax with a -1e4 fill, conv FFN with
asymmetric same-padding. The relative terms are computed banded ([L, 2w+1]
products) and moved between band and dense form with one gather each.

In training (`train=True`) dropout with p_dropout falls where the JAX
package puts it (nn/attention.py:129-130, :161-162, :195-206): on the
attention weights, after the FFN's ReLU, and on each sublayer's output
before its residual. Its masks come from an explicit torch.Generator.

Public layout: x [B, T, C], x_mask [B, T, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv1d, LayerNorm


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout as flax's nn.Dropout: keep with probability 1 - p,
    scale kept values by 1 / (1 - p); the mask is drawn from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _rel_index(length: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(band column of each dense (i, j), validity): column j - i + w."""
    i = torch.arange(length, device=device)
    col = i[None, :] - i[:, None] + w
    valid = (col >= 0) & (col <= 2 * w)
    return col.clamp(0, 2 * w), valid


def _band_to_absolute(band: torch.Tensor, w: int) -> torch.Tensor:
    """[..., L, 2w+1] (column c = diagonal c - w) -> [..., L, L], zero
    outside the band."""
    length = band.shape[-2]
    col, valid = _rel_index(length, w, band.device)
    dense = torch.gather(band, -1, col.expand(band.shape[:-1] + (length,)))
    return torch.where(valid, dense, torch.zeros((), dtype=band.dtype, device=band.device))


def _absolute_to_band(x: torch.Tensor, w: int) -> torch.Tensor:
    """[..., L, L] -> [..., L, 2w+1] with band[i, c] = x[i, i + c - w],
    zero out of range."""
    length = x.shape[-1]
    i = torch.arange(length, device=x.device)
    j = i[:, None] + torch.arange(2 * w + 1, device=x.device)[None, :] - w
    valid = (j >= 0) & (j < length)
    band = torch.gather(x, -1, j.clamp(0, length - 1).expand(x.shape[:-1] + (2 * w + 1,)))
    return torch.where(valid, band, torch.zeros((), dtype=x.dtype, device=x.device))


def _effective_window(emb: torch.Tensor, length: int, window_size: int):
    """(table [2w_eff+1, d], w_eff): for length <= window_size the reference
    slices the table down (vits/attentions.py:324-334)."""
    w_eff = min(window_size, length - 1)
    start = window_size - w_eff
    return emb[0, start : start + 2 * w_eff + 1], w_eff


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int | None = None, p_dropout: float = 0.0):
        super().__init__()
        self.channels, self.n_heads, self.window_size = channels, n_heads, window_size
        self.p_dropout = p_dropout
        self.k_channels = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:
            self.emb_rel_k = nn.Parameter(torch.empty(1, 2 * window_size + 1, self.k_channels))
            self.emb_rel_v = nn.Parameter(torch.empty(1, 2 * window_size + 1, self.k_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in (self.conv_q, self.conv_k, self.conv_v, self.conv_o):
            conv.init_weights(generator)
        if self.window_size is not None:
            with torch.no_grad():
                for emb in (self.emb_rel_k, self.emb_rel_v):
                    emb.normal_(0.0, self.k_channels ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, T, C] (self-attention), attn_mask [B, 1, T, T]."""
        b, t, _ = x.shape
        h, dk = self.n_heads, self.k_channels

        def heads(y):  # [B, T, C] -> [B, H, T, Dk]
            return y.view(b, t, h, dk).transpose(1, 2)

        q = heads(self.conv_q.forward_ntc(x)) * (1.0 / math.sqrt(dk))
        k = heads(self.conv_k.forward_ntc(x))
        v = heads(self.conv_v.forward_ntc(x))
        scores = q @ k.transpose(-1, -2)
        if self.window_size is not None:
            key_rel, w = _effective_window(self.emb_rel_k, t, self.window_size)
            scores = scores + _band_to_absolute(q @ key_rel.t(), w)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = F.softmax(scores, dim=-1)
        if train and self.p_dropout > 0:
            p_attn = dropout(p_attn, self.p_dropout, generator)
        out = p_attn @ v
        if self.window_size is not None:
            value_rel, w = _effective_window(self.emb_rel_v, t, self.window_size)
            out = out + _absolute_to_band(p_attn, w) @ value_rel
        out = out.transpose(1, 2).reshape(b, t, self.channels)
        return self.conv_o.forward_ntc(out)


class FFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.p_dropout = kernel_size, p_dropout
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size)

    def init_weights(self, generator: torch.Generator) -> None:
        self.conv_1.init_weights(generator)
        self.conv_2.init_weights(generator)

    def _same_pad(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size == 1:
            return x
        return F.pad(x, ((self.kernel_size - 1) // 2, self.kernel_size // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1]."""
        x, mask = x.transpose(1, 2), x_mask.transpose(1, 2)
        x = torch.relu(self.conv_1(self._same_pad(x * mask)))
        if train and self.p_dropout > 0:
            x = dropout(x, self.p_dropout, generator)
        x = self.conv_2(self._same_pad(x * mask)) * mask
        return x.transpose(1, 2)


class RelPosTransformer(nn.Module):
    """Encoder stack (reference vits/attentions.py:12-72)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, window_size,
                               p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, filter_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def init_weights(self, generator: torch.Generator) -> None:
        for attn, ffn in zip(self.attn_layers, self.ffn_layers):
            attn.init_weights(generator)
            ffn.init_weights(generator)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1] -> [B, T, C]. train=True applies
        dropout with masks from `generator`."""
        drop = train and self.p_dropout > 0
        m = x_mask[..., 0]
        attn_mask = m[:, None, :, None] * m[:, None, None, :]
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            y = attn(x, attn_mask, train, generator)
            if drop:
                y = dropout(y, self.p_dropout, generator)
            x = norm1(x + y)
            y = ffn(x, x_mask, train, generator)
            if drop:
                y = dropout(y, self.p_dropout, generator)
            x = norm2(x + y)
        return x * x_mask
