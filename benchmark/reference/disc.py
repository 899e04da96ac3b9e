"""The discriminators and losses of so-vits-svc 5.0 in plain PyTorch
(vits_decoder/{mpd,mrd,msd,discriminator}.py, vits/losses.py,
vits_extend/{stft,stft_loss,train}.py), frozen as the benchmark's reference.

Spectrograms are frames @ [cos | sin] DFT basis, the window of win_length
centred in n_fft, as a matrix product; the mel filterbank is librosa's
slaney one, made here in numpy.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv1d, Conv2d


@lru_cache(maxsize=None)
def dft_basis(n_fft: int, win_length: int, window: str) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * n / win_length) if window == "hann" else np.ones(win_length)
    full = np.zeros(n_fft)
    lo = (n_fft - win_length) // 2
    full[lo : lo + win_length] = w
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    phase = 2 * np.pi * k * np.arange(n_fft, dtype=np.float64)[:, None] / n_fft
    return (full[:, None] * np.concatenate([np.cos(phase), np.sin(phase)], axis=1)).astype(np.float32)


def _reflect(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(y[:, None], (left, right), mode="reflect")[:, 0]


def stft_mag(y: torch.Tensor, n_fft: int, hop: int, win: int, window: str = "hann",
             mag_eps: float = 0.0, clamp: float = 0.0) -> torch.Tensor:
    """[B, S] (already padded) -> [B, frames, bins], centre off."""
    basis = torch.from_numpy(dft_basis(n_fft, win, window)).to(y.device)
    spec = y.unfold(-1, n_fft, hop) @ basis
    nb = n_fft // 2 + 1
    power = spec[..., :nb].square() + spec[..., nb:].square()
    if clamp:
        power = power.clamp_min(clamp)
    return torch.sqrt(power + mag_eps)


def _prepad(y, n_fft, hop):
    p = int((n_fft - hop) / 2)
    return _reflect(y, p, p)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel, slaney scale and norm: [n_mels, bins]."""
    def to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (np.maximum(m, 15.0) - 15.0)),
                        m * (200.0 / 3))

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fd = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    w *= (2.0 / (hz[2 : n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(y, d):
    """TacotronSTFT: reflect pre-pad, hann, eps 1e-9 under the root, slaney
    mel, log of the mel clamped at 1e-5. [B, S] -> [B, frames, mels]."""
    n_fft = d["filter_length"]
    mag = stft_mag(_prepad(y, n_fft, d["hop_length"]), n_fft, d["hop_length"], d["win_length"],
                   mag_eps=1e-9)
    fb = mel_filterbank(d["sampling_rate"], n_fft, d["mel_channels"], d["mel_fmin"], d["mel_fmax"])
    return torch.log((mag @ torch.from_numpy(np.ascontiguousarray(fb.T)).to(y.device))
                     .clamp_min(1e-5))


class DiscriminatorP(nn.Module):
    def __init__(self, period, k, stride, slope):
        super().__init__()
        self.period, self.slope = period, slope
        chs = [1, 64, 128, 256, 512]
        convs = [Conv2d(chs[i], chs[i + 1], (k, 1), (stride, 1), (k // 2, 0)) for i in range(4)]
        convs.append(Conv2d(512, 1024, (k, 1), (1, 1), (k // 2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x):  # [B, 1, T]
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        x = x.reshape(b, c, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.slope)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap, x.flatten(1)


class DiscriminatorR(nn.Module):
    def __init__(self, resolution, slope):
        super().__init__()
        self.res, self.slope = tuple(resolution), slope
        self.convs = nn.ModuleList([
            Conv2d(1, 32, (3, 9), (1, 1), (1, 4)), Conv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            Conv2d(32, 32, (3, 9), (1, 2), (1, 4)), Conv2d(32, 32, (3, 9), (1, 2), (1, 4)),
            Conv2d(32, 32, (3, 3), (1, 1), (1, 1))])
        self.conv_post = Conv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x):
        n_fft, hop, win = self.res
        # the reference's MRD front end: no window, no eps
        h = stft_mag(_prepad(x[:, 0], n_fft, hop), n_fft, hop, win, window="ones")
        h = h.transpose(1, 2)[:, None]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.slope)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return fmap, h.flatten(1)


class ScaleDiscriminator(nn.Module):
    SPECS = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
             (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256), (1024, 1024, 5, 1, 2, 1))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(i, o, k, stride=s, padding=p, groups=g, wn=True)
                                   for i, o, k, s, p, g in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, padding=1, wn=True)

    def forward(self, x):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap, x.flatten(1)


class Group(nn.Module):
    def __init__(self, discs):
        super().__init__()
        self.discriminators = nn.ModuleList(discs)


class Discriminator(nn.Module):
    """MRD + MPD + MSD; (fmaps, score) pairs in that order."""

    def __init__(self, hp):
        super().__init__()
        mpd, mrd = hp["mpd"], hp["mrd"]
        self.MRD = Group(DiscriminatorR(r, mrd["lReLU_slope"]) for r in mrd["resolutions"])
        self.MPD = Group(DiscriminatorP(p, mpd["kernel_size"], mpd["stride"], mpd["lReLU_slope"])
                         for p in mpd["periods"])
        self.MSD = ScaleDiscriminator()

    def forward(self, x):  # [B, T, 1]
        x = x.transpose(1, 2)
        return ([d(x) for d in self.MRD.discriminators] + [d(x) for d in self.MPD.discriminators]
                + [self.MSD(x)])


def kl_loss(z, logs_q, m_p, logs_p, logdet, mask):
    kl = logs_p - logs_q - 0.5 + 0.5 * torch.square(z - m_p) * torch.exp(-2.0 * logs_p)
    return (torch.sum(kl * mask) - torch.sum(logdet)) / torch.sum(mask)


def mr_stft_loss(fake, real, resolutions):
    """(spectral convergence, log-magnitude L1), each averaged over the
    resolutions; centre-padded hann STFTs, power floored at 1e-7."""
    sc = mag = 0.0
    for n_fft, hop, win in resolutions:
        x = stft_mag(_reflect(fake, n_fft // 2, n_fft // 2), n_fft, hop, win, clamp=1e-7)
        y = stft_mag(_reflect(real, n_fft // 2, n_fft // 2), n_fft, hop, win, clamp=1e-7)
        sc = sc + torch.linalg.vector_norm(y - x) / torch.linalg.vector_norm(y)
        mag = mag + torch.mean(torch.abs(torch.log(y) - torch.log(x)))
    return sc / len(resolutions), mag / len(resolutions)


def gan_terms(disc, n):
    """(score loss, feature matching, D loss) of one D forward on fake || real."""
    fake = [([f[:n] for f in fm], s[:n]) for fm, s in disc]
    real = [([f[n:] for f in fm], s[n:]) for fm, s in disc]
    k = len(disc)
    score = sum(torch.mean(torch.square(s - 1.0)) for _, s in fake) / k
    feat = sum(torch.mean(torch.abs(a - b.detach())) for (fa, _), (fr, _) in zip(fake, real)
               for a, b in zip(fa, fr)) / k * 2.0
    d_loss = sum(torch.mean(torch.square(sr - 1.0)) + torch.mean(torch.square(sf))
                 for (_, sf), (_, sr) in zip(fake, real)) / k
    return score, feat, d_loss
