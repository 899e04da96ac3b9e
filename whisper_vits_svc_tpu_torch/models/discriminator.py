"""Composite GAN discriminator: MRD + MPD + MSD (reference
vits_decoder/{discriminator,mpd,mrd,msd}.py, JAX models/discriminator.py).

Returns a list of (feature_maps, score) pairs in MRD, MPD, MSD order. Audio
in is [B, T, 1] (the JAX layout); feature maps are torch NCHW / NCT, scores
[B, n] in the JAX order. The JAX package's TPU layout devices (the MRD's
4-way frequency fold, the MSD's merged groups) compute the same values as
the plain forms used here. Parameter names are the reference state_dict's:
`MRD.discriminators.{i}`, `MPD.discriminators.{i}`, `MSD`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import Conv1d, Conv2d
from ..ops.stft import mrd_magnitude


class DiscriminatorP(nn.Module):
    """Period discriminator (reference vits_decoder/mpd.py:6-44)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 lrelu_slope: float = 0.2):
        super().__init__()
        self.period, self.lrelu_slope = period, lrelu_slope
        pad = (kernel_size // 2, 0)
        chs = [1, 64, 128, 256, 512]
        convs = [Conv2d(chs[i], chs[i + 1], (kernel_size, 1), (stride, 1), pad)
                 for i in range(4)]
        convs.append(Conv2d(512, 1024, (kernel_size, 1), (1, 1), pad))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (fmaps [B, C, T/p, p], score [B, n])."""
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
        return fmap, x.flatten(1)


class DiscriminatorR(nn.Module):
    """Resolution discriminator on the window-less STFT magnitude
    (reference vits_decoder/mrd.py:6-46)."""

    def __init__(self, resolution, lrelu_slope: float = 0.2):
        super().__init__()
        self.resolution, self.lrelu_slope = tuple(resolution), lrelu_slope
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
        h = mrd_magnitude(x[:, 0], n_fft, hop, win).transpose(1, 2)[:, None]  # [B,1,bins,frames]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.lrelu_slope)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return fmap, h.flatten(1)


class ScaleDiscriminator(nn.Module):
    """Raw-waveform scale discriminator (reference vits_decoder/msd.py:7-29):
    grouped k=41 stride-4 convs, leaky ReLU 0.1."""

    SPECS = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
             (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256),
             (1024, 1024, 5, 1, 2, 1))  # in, out, kernel, stride, padding, groups

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(i, o, k, stride=s, padding=p, groups=g, weight_norm=True)
            for i, o, k, s, p, g in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (fmaps [B, C, T'], score [B, n])."""
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap, x.flatten(1)


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions, lrelu_slope: float = 0.2):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(r, lrelu_slope) for r in resolutions)


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods, kernel_size: int = 5, stride: int = 3,
                 lrelu_slope: float = 0.2):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, kernel_size, stride, lrelu_slope) for p in periods)


class Discriminator(nn.Module):
    """MRD + MPD + MSD (reference vits_decoder/discriminator.py:10-21)."""

    def __init__(self, mrd_resolutions=((1024, 120, 600), (2048, 240, 1200),
                                        (4096, 480, 2400), (512, 50, 240)),
                 mpd_periods=(2, 3, 5, 7, 11), mpd_kernel_size: int = 5,
                 mpd_stride: int = 3, lrelu_slope: float = 0.2):
        super().__init__()
        self.MRD = MultiResolutionDiscriminator(mrd_resolutions, lrelu_slope)
        self.MPD = MultiPeriodDiscriminator(mpd_periods, mpd_kernel_size, mpd_stride,
                                            lrelu_slope)
        self.MSD = ScaleDiscriminator()

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
