"""Salience-based F0 estimation, Melodia-style harmonic summation (JAX
whisper_vits_svc_tpu/models/salience.py; the reference vendors libf0's
salience, pitch/core/salience.py:13-441, Salamon & Gomez 2012).

  * the complex STFT on the device (ops/stft.py::stft_complex);
  * instantaneous frequency from the heterodyned phase increment between
    frames, the IF-binned log-frequency spectrogram (R cents a bin) and its
    vertical hanning smoothing: float64 numpy on the host, as the JAX
    package keeps them (np.add.at binning);
  * the harmonic summation as one banded [B, B] weighting matrix times the
    [B, T] spectrogram, a float32 product on the device;
  * trajectory tracking with the toeplitz high/low-score transition matrix,
    decoded by f0_alt._viterbi_generic (trellis on the device).

As in the JAX package, `gamma_db > 0` zeroes bins more than gamma_db dB below
the global maximum and the default (0) disables the threshold (the
reference's default keeps every bin but the loudest, an apparent sign slip).
`device` is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.stft import stft_complex
from ..utils.device import resolve_device
from .f0_alt import _viterbi_generic


def _freq_to_bin(f, r_cents: float, f_ref: float):
    """Variable-resolution binning (salience.py:420-441); bin 0 at f_ref."""
    return np.floor((1200.0 / r_cents) * np.log2(f / f_ref) + 0.5).astype(np.int64)


@lru_cache(maxsize=None)
def _harmonic_weight_matrix(n_bins: int, r_cents: float, num_harm: int,
                            alpha: float, win_len: int = 11) -> np.ndarray:
    """[B, B] banded harmonic-summation matrix W; Z = W @ lf_spec.

    Row b sums cosine^2-windowed neighborhoods around each harmonic offset
    h_k = round(log2(k) * 1200 / R) bins above b, weighted alpha^(k-1)
    (salience.py:239-255).
    """
    half = win_len // 2
    window = np.cos(np.linspace(-1, 1, 2 * half + 1) * np.pi / 2) ** 2
    harmonics = np.round(np.log2(np.arange(1, num_harm + 1)) * 1200.0 / r_cents).astype(int)
    W = np.zeros((n_bins, n_bins), np.float32)
    for k, h in enumerate(harmonics):
        for j, w in enumerate(window):
            off = h + j - half
            src = np.arange(n_bins) + off
            ok = (src >= 0) & (src < n_bins)
            W[np.arange(n_bins)[ok], src[ok]] += w * alpha**k
    return W


def _threshold(spec: np.ndarray, gamma_db: float) -> np.ndarray:
    if gamma_db <= 0.0:
        return spec
    eps = np.finfo(np.float32).eps
    level = 20.0 * np.log10(spec / (spec.max() + eps) + eps)
    return spec * (level >= -gamma_db)


def salience(
    x: np.ndarray,
    fs: int = 16000,
    n_fft: int = 2048,
    hop: int = 160,
    fmin: float = 55.0,
    fmax: float = 1000.0,
    r_cents: float = 10.0,
    num_harm: int = 10,
    freq_smooth_len: int = 11,
    alpha: float = 0.9,
    gamma_db: float = 0.0,
    tol: int = 5,
    score_low: float = 0.01,
    score_high: float = 1.0,
    device: str | torch.device | None = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """-> (f0 [T], salience in [0,1] [T]) at the STFT frame rate (hop)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    re, im = stft_complex(torch.from_numpy(x)[None].to(dev), n_fft, hop, n_fft)
    re = re[0].cpu().numpy().astype(np.float64).T  # [bins, frames], freq-major as reference
    im = im[0].cpu().numpy().astype(np.float64).T
    n_bins_fft, T = re.shape

    # --- instantaneous frequency from heterodyned phase increment ---
    k = np.arange(n_bins_fft)[:, None]
    omega = 2.0 * np.pi * k / n_fft  # rad/sample
    phase = np.arctan2(im, re)
    hpi = (phase[:, 1:] - phase[:, :-1]) - omega * hop
    hpi = hpi - 2.0 * np.pi * (np.around(hpi / (2.0 * np.pi) + 1.0) - 1.0)
    inst_f = (omega + hpi / hop) * fs / (2.0 * np.pi)
    inst_f = np.hstack([inst_f[:, :1], inst_f])  # repeat first frame

    B = int(_freq_to_bin(np.asarray(fmax), r_cents, fmin)) + 1
    f_coef = fmin * 2.0 ** (np.arange(B) * r_cents / 1200.0)

    valid = (inst_f >= fmin) & (inst_f < fmax)
    bin_idx = np.where(valid, _freq_to_bin(np.maximum(inst_f, fmin), r_cents, fmin), B)
    bin_idx = np.clip(bin_idx, 0, B)

    power = re**2 + im**2
    lf = np.zeros((B + 1, T))
    np.add.at(lf, (bin_idx, np.arange(T)[None, :].repeat(n_bins_fft, 0)), power)
    lf = lf[:B]

    # vertical smoothing with a hanning window (constant-padded correlation)
    w = np.hanning(freq_smooth_len)
    half = freq_smooth_len // 2
    padded = np.pad(lf, ((half, half), (0, 0)))
    lf = sum(w[j] * padded[j : j + B] for j in range(freq_smooth_len))

    # harmonic summation, a float32 product on the device
    W = _harmonic_weight_matrix(B, r_cents, num_harm, alpha, 11)
    lf = _threshold(lf, gamma_db)
    Z = (torch.from_numpy(W).to(dev) @ torch.from_numpy(lf.astype(np.float32)).to(dev))
    Z = Z.cpu().numpy().astype(np.float64)
    Z = _threshold(np.maximum(Z, 0.0), gamma_db)

    # toeplitz transition: score_high within tol bins, score_low outside
    idx = np.abs(np.subtract.outer(np.arange(B), np.arange(B)))
    trans = np.where(idx <= tol, score_high, score_low)

    path = _viterbi_generic(np.maximum(Z.T, 1e-30), trans, dev)  # [T]
    f0 = f_coef[path]
    z_max = np.maximum(Z.max(axis=0), 1e-30)
    sal = Z[path, np.arange(T)] / z_max
    return f0.astype(np.float32), sal.astype(np.float32)


def compute_f0_sing_salience(x: np.ndarray, fs: int = 16000,
                             device: str | torch.device | None = "cuda") -> np.ndarray:
    """Reference-convention inference F0 (pitch/inference.py:31-44): salience
    at hop 320 / N 2048 / [45, 1760] Hz, repeated x2 to the 160-sample frame
    rate and smoothed with a length-3 moving average."""
    f0, _sal = salience(np.asarray(x, np.float32), fs=fs, n_fft=2048, hop=320,
                        fmin=45.0, fmax=1760.0, device=device)
    f0 = np.repeat(f0, 2, -1)
    return np.convolve(f0, np.ones(3) / 3.0, mode="same").astype(np.float32)


def compute_f0_salience(
    x: np.ndarray,
    fs: int = 16000,
    hop: int = 160,
    voicing_threshold: float = 0.15,
    device: str | torch.device | None = "cuda",
    **kw,
) -> np.ndarray:
    """`.pit.npy`-compatible wrapper: f0 with low-salience frames zeroed,
    trimmed/padded to the 1 + len(x)//hop convention of the other engines."""
    f0, sal = salience(x, fs=fs, hop=hop, device=device, **kw)
    f0 = np.where(sal >= voicing_threshold, f0, 0.0).astype(np.float32)
    n = 1 + len(x) // hop
    if len(f0) < n:
        f0 = np.pad(f0, (0, n - len(f0)))
    return f0[:n]
