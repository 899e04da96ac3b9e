"""Composite GAN discriminator: MRD + MPD + MSD (reference
vits_decoder/{discriminator,mpd,mrd,msd}.py, JAX models/discriminator.py).

Returns a list of (feature_maps, score) pairs in MRD, MPD, MSD order.
`MelspecDiscriminator` (the 48 kHz mel discriminator) is in no
`Discriminator`, as in the reference and the JAX package. Audio
in is [B, T, 1] (the JAX layout); feature maps are torch NCHW / NCT, scores
[B, n] in the JAX order. The JAX package's TPU layout devices (the MRD's
4-way frequency fold, the MSD's merged groups) compute the same values as
the plain forms used here. Parameter names are the reference state_dict's:
`MRD.discriminators.{i}`, `MPD.discriminators.{i}`, `MSD`.

`compute_dtype=torch.bfloat16` (hp.train.bf16_discriminator) runs the conv
stacks in bfloat16 as the JAX package does: the input is cast (after the
MRD's STFT front end, which stays float32), each weight-normed kernel is
computed in float32 and cast, and the feature maps and scores come back as
float32. Parameters and their gradients stay float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import Conv1d, Conv2d, uniform_init_
from ..ops.mel import mel_filterbank
from ..ops.stft import mrd_magnitude, stft_magnitude


def _to_f32(fmap: list, score: torch.Tensor):
    return [f.float() for f in fmap], score.float()


class DiscriminatorP(nn.Module):
    """Period discriminator (reference vits_decoder/mpd.py:6-44)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 lrelu_slope: float = 0.2, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.period, self.lrelu_slope = period, lrelu_slope
        self.compute_dtype = compute_dtype
        pad = (kernel_size // 2, 0)
        chs = [1, 64, 128, 256, 512]
        convs = [Conv2d(chs[i], chs[i + 1], (kernel_size, 1), (stride, 1), pad)
                 for i in range(4)]
        convs.append(Conv2d(512, 1024, (kernel_size, 1), (1, 1), pad))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (fmaps [B, C, T/p, p], score [B, n])."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
            t = x.shape[-1]
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.lrelu_slope)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return _to_f32(fmap, x.flatten(1))


class DiscriminatorR(nn.Module):
    """Resolution discriminator on the window-less STFT magnitude
    (reference vits_decoder/mrd.py:6-46)."""

    def __init__(self, resolution, lrelu_slope: float = 0.2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.resolution, self.lrelu_slope = tuple(resolution), lrelu_slope
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleList([
            Conv2d(1, 32, (3, 9), (1, 1), (1, 4)),
            Conv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            Conv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            Conv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            Conv2d(32, 32, (3, 3), (1, 1), (1, 1)),
        ])
        self.conv_post = Conv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (fmaps [B, C, bins, frames'], score [B, n])."""
        n_fft, hop, win = self.resolution
        # the STFT front end stays float32 (its magnitudes cancel)
        h = mrd_magnitude(x[:, 0].float(), n_fft, hop, win).transpose(1, 2)[:, None]
        if self.compute_dtype is not None:  # [B, 1, bins, frames]
            h = h.to(self.compute_dtype)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.lrelu_slope)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return _to_f32(fmap, h.flatten(1))


class ScaleDiscriminator(nn.Module):
    """Raw-waveform scale discriminator (reference vits_decoder/msd.py:7-29):
    grouped k=41 stride-4 convs, leaky ReLU 0.1."""

    SPECS = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
             (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256),
             (1024, 1024, 5, 1, 2, 1))  # in, out, kernel, stride, padding, groups

    def __init__(self, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleList(
            Conv1d(i, o, k, stride=s, padding=p, groups=g, weight_norm=True)
            for i, o, k, s, p, g in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (fmaps [B, C, T'], score [B, n])."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return _to_f32(fmap, x.flatten(1))


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions, lrelu_slope: float = 0.2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(r, lrelu_slope, compute_dtype)
                                            for r in resolutions)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods, kernel_size: int = 5, stride: int = 3,
                 lrelu_slope: float = 0.2, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, kernel_size, stride, lrelu_slope, compute_dtype) for p in periods)


class Discriminator(nn.Module):
    """MRD + MPD + MSD (reference vits_decoder/discriminator.py:10-21)."""

    def __init__(self, mrd_resolutions=((1024, 120, 600), (2048, 240, 1200),
                                        (4096, 480, 2400), (512, 50, 240)),
                 mpd_periods=(2, 3, 5, 7, 11), mpd_kernel_size: int = 5,
                 mpd_stride: int = 3, lrelu_slope: float = 0.2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.MRD = MultiResolutionDiscriminator(mrd_resolutions, lrelu_slope, compute_dtype)
        self.MPD = MultiPeriodDiscriminator(mpd_periods, mpd_kernel_size, mpd_stride,
                                            lrelu_slope, compute_dtype)
        self.MSD = ScaleDiscriminator(compute_dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights with the JAX package's initializers."""
        for m in self.modules():
            if isinstance(m, (Conv1d, Conv2d)):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor):
        """x [B, T, 1] -> [(fmaps, score)] in MRD, MPD, MSD order."""
        x = x.transpose(1, 2)
        out = [d(x) for d in self.MRD.discriminators]
        out += [d(x) for d in self.MPD.discriminators]
        out.append(self.MSD(x))
        return out


class MelspecDiscriminator(nn.Module):
    """48 kHz mel-spectrogram discriminator (reference vits_decoder/med.py:6-65,
    JAX models/discriminator.py:210-253): the centered magnitude STFT
    (n_fft 2048, 25 ms window, 10 ms hop), 128 HTK mel bands with no norm,
    log(mel + 1e-5), four bias-free Conv2d(64) each followed by a
    BatchNorm2d and a GLU over the channels, and a (15, 3) postnet averaged
    to one score an item. Keys are the reference's: `_convs.{i}.0` (conv),
    `_convs.{i}.1` (BatchNorm2d), `_postnet`. In eval mode the BatchNorm is
    the JAX package's per-channel scale and bias; in train mode it takes the
    batch's statistics, as the reference's does."""

    KERNELS = ((7, 7), (4, 4), (4, 4), (4, 4))
    N_FFT, N_MELS = 2048, 128

    def __init__(self, sample_rate: int = 48000):
        super().__init__()
        self.sample_rate = sample_rate
        self.win, self.hop = int(0.025 * sample_rate), int(0.010 * sample_rate)
        self._convs = nn.ModuleList(
            nn.Sequential(nn.Conv2d(1 if i == 0 else 32, 64, k, stride=(1, 2), padding=(1, 2),
                                    bias=False),
                          nn.BatchNorm2d(64), nn.GLU(dim=1))
            for i, k in enumerate(self.KERNELS))
        self._postnet = nn.Conv2d(32, 1, (15, 3), stride=(1, 2))
        basis = mel_filterbank(sample_rate, self.N_FFT, self.N_MELS, htk=True, norm=None)
        self.register_buffer("mel_basis", torch.from_numpy(np.ascontiguousarray(basis.T)),
                             persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: U(-b, b), b = 1/sqrt(fan_in), for
        the convolutions and the postnet's bias; scale 1 and bias 0, with
        running statistics that make the eval-mode BatchNorm that affine map
        (mean 0, var 1 - eps)."""
        for block in self._convs:
            conv, bn = block[0], block[1]
            uniform_init_(conv.weight, conv.weight[0].numel(), generator)
            nn.init.ones_(bn.weight)
            nn.init.zeros_(bn.bias)
            nn.init.zeros_(bn.running_mean)
            nn.init.constant_(bn.running_var, 1.0 - bn.eps)
        fan_in = self._postnet.weight[0].numel()
        uniform_init_(self._postnet.weight, fan_in, generator)
        uniform_init_(self._postnet.bias, fan_in, generator)

    def forward(self, x: torch.Tensor):
        """x [B, T, 1] -> [(fmaps [B, 32, mels', frames'] x 4, score [B])]."""
        mag = stft_magnitude(x[..., 0].float(), self.N_FFT, self.hop, self.win, center=True)
        h = torch.log(mag @ self.mel_basis + 1e-5).transpose(1, 2)[:, None]
        fmap = []
        for block in self._convs:
            h = block(h)
            fmap.append(h)
        return [(fmap, self._postnet(h).mean(dim=(1, 2, 3)))]
