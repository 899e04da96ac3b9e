"""Matmul STFT: the three spectrogram conventions of the training losses and
the MRD discriminator (JAX whisper_vits_svc_tpu/ops/stft.py).

A spectrogram is frames[B, T_frames, n_fft] @ basis[n_fft, 2 * n_bins], the
windowed DFT basis of the JAX package ([cos | sin] columns, the window of
win_length zero-padded centered to n_fft, as torch.stft does), so the numbers
match the JAX package's. Framing is `Tensor.unfold`, whose autograd adjoint is
the overlap-add.

  * `linear_spectrogram`: the VITS linear spectrogram (reference
    vits/spectrogram.py:41-76), as `mel_spectrogram` before the mel
    projection, eps 1e-6; validation's spectrogram panels use it;
  * `mel_spectrogram`: TacotronSTFT (reference vits_extend/stft.py:76-110):
    reflect pre-pad (n_fft - hop)/2, center=False, hann, eps 1e-9 under the
    sqrt, log of the mel clamped at 1e-5;
  * `stft_loss_magnitude`: the MR-STFT loss (vits_extend/stft_loss.py:12-29):
    center=True with reflect padding, hann, power clamped at 1e-7;
  * `mrd_magnitude`: the MRD front end (vits_decoder/mrd.py:39-46): reflect
    pre-pad, center=False, NO window (rectangular ones(win_length)) and no eps
    under the sqrt; both quirks are the reference's.

Outputs are [B, frames, bins].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank

_device_cache: dict = {}


@lru_cache(maxsize=None)
def _windowed_dft(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """[n_fft, 2*n_bins] windowed DFT basis: [cos | sin] columns, float32."""
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft})")
    n_bins = n_fft // 2 + 1
    if window == "hann":
        n = np.arange(win_length, dtype=np.float64)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    elif window == "ones":
        w = np.ones(win_length, dtype=np.float64)
    else:
        raise ValueError(f"unknown window {window!r}")
    pad_l = (n_fft - win_length) // 2
    w_full = np.zeros(n_fft, dtype=np.float64)
    w_full[pad_l : pad_l + win_length] = w
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * n / n_fft
    basis = np.concatenate([np.cos(phase), np.sin(phase)], axis=1)
    return (w_full[:, None] * basis).astype(np.float32)


def _on(device: torch.device, key: tuple, make) -> torch.Tensor:
    """A constant built once per device (the n_fft=4096 basis is 67 MB)."""
    k = (str(device),) + key
    if k not in _device_cache:
        _device_cache[k] = torch.from_numpy(make()).to(device)
    return _device_cache[k]


def _reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (left, right), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int, *,
                   window: str = "hann", center: bool = False, mag_eps: float = 0.0,
                   mag_clamp: float = 0.0) -> torch.Tensor:
    """Magnitude STFT, [B, T] -> [B, frames, n_fft//2+1], float32.
    center=True reflect-pads n_fft//2 each side; mag_eps is added under the
    sqrt; mag_clamp floors the power first."""
    y = y.float()
    if center:
        y = _reflect_pad(y, n_fft // 2, n_fft // 2)
    frames = y.unfold(-1, n_fft, hop)
    basis = _on(y.device, ("dft", n_fft, win_length, window),
                lambda: _windowed_dft(n_fft, win_length, window))
    spec = frames @ basis
    n_bins = n_fft // 2 + 1
    power = spec[..., :n_bins].square() + spec[..., n_bins:].square()
    if mag_clamp > 0.0:
        power = power.clamp_min(mag_clamp)
    return torch.sqrt(power + mag_eps)


def _vits_prepad(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    pad = int((n_fft - hop) / 2)
    return _reflect_pad(y, pad, pad)


def linear_spectrogram(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """VITS linear spectrogram (reference vits/spectrogram.py:41-76): reflect
    pre-pad, center=False, hann, eps 1e-6 under the sqrt.
    [B, T] -> [B, frames, n_fft//2+1]."""
    return stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                          center=False, mag_eps=1e-6)


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, hop: int,
                    win_length: int, fmin: float = 0.0, fmax: float | None = None, *,
                    mag_eps: float = 1e-9) -> torch.Tensor:
    """Log-mel spectrogram, [B, T] -> [B, frames, num_mels] (TacotronSTFT)."""
    mag = stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                         center=False, mag_eps=mag_eps)
    mel_w = _on(mag.device, ("mel", sampling_rate, n_fft, num_mels, fmin, fmax),
                lambda: np.ascontiguousarray(
                    mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax).T))
    return torch.log((mag @ mel_w).clamp_min(1e-5))


def stft_loss_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Magnitude of the MR-STFT loss: center=True, reflect, hann, power
    clamped at 1e-7. [B, T] -> [B, frames, bins]."""
    return stft_magnitude(y, n_fft, hop, win_length, center=True, mag_clamp=1e-7)


def mrd_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Magnitude fed to the MRD: reflect pre-pad (n_fft - hop)/2,
    center=False, rectangular window, no eps. [B, T] -> [B, frames, bins]."""
    return stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                          window="ones", center=False)
