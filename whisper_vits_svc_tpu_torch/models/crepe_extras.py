"""CREPE auxiliaries: U/V thresholding, A-weighted loudness, simple decoders
(JAX whisper_vits_svc_tpu/models/crepe_extras.py).

Reference crepe/threshold.py:12-110 (At, Hysteresis), crepe/loudness.py:28-81
(A-weighted per-frame loudness), crepe/decode.py:13-52 (argmax /
weighted_argmax alternatives to viterbi): numpy, host-side post-processing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stft import stft_magnitude
from .crepe import CENTS_PER_BIN, CENTS_OFFSET, PITCH_BINS, SAMPLE_RATE, WINDOW_SIZE

UNVOICED = np.nan
MIN_DB = -100.0
REF_DB = 20.0


class At:
    """pitch[periodicity < value] = unvoiced (threshold.py:12-25)."""

    def __init__(self, value: float):
        self.value = value

    def __call__(self, pitch: np.ndarray, periodicity: np.ndarray) -> np.ndarray:
        pitch = pitch.copy().astype(np.float64)
        pitch[periodicity < self.value] = UNVOICED
        return pitch


class Hysteresis:
    """Hysteresis U/V thresholding in log2-pitch space (threshold.py:28-105)."""

    def __init__(self, lower_bound=0.19, upper_bound=0.31, width=0.2,
                 stds=1.7, return_threshold=False):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.width = width
        self.stds = stds
        self.return_threshold = return_threshold

    def __call__(self, pitch: np.ndarray, periodicity: np.ndarray):
        pitch = np.log2(np.asarray(pitch, np.float64)).flatten()
        periodicity = np.asarray(periodicity, np.float64).flatten()

        pitch[periodicity < self.lower_bound] = UNVOICED
        mean, std = np.nanmean(pitch), np.nanstd(pitch)
        pitch = (pitch - mean) / std

        parabola = self.width * pitch**2 - self.width * self.stds**2
        threshold = self.lower_bound + np.clip(parabola, 0, 1 - self.lower_bound)
        threshold[np.isnan(threshold)] = self.lower_bound

        i = 0
        while i < len(periodicity) - 1:
            if periodicity[i] < threshold[i] and periodicity[i + 1] > threshold[i + 1]:
                start, end, keep = i + 1, i + 1, False
                while end < len(periodicity) and periodicity[end] > threshold[end]:
                    if periodicity[end] > self.upper_bound:
                        keep = True
                    end += 1
                if not keep:
                    threshold[start:end] = 1
                i = end
            else:
                i += 1

        pitch[periodicity < threshold] = UNVOICED
        pitch = pitch * std + mean
        pitch = 2.0**pitch
        if self.return_threshold:
            return pitch[None, :], threshold
        return pitch[None, :]


def a_weighting_db(frequencies: np.ndarray) -> np.ndarray:
    """IEC 61672 A-weighting curve in dB (librosa.A_weighting equivalent)."""
    f2 = np.square(np.asarray(frequencies, np.float64))
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    num = const[0] * f2**2
    den = (f2 + const[0]) * (f2 + const[1]) * np.sqrt((f2 + const[2]) * (f2 + const[3]))
    with np.errstate(divide="ignore"):
        return 2.0 + 20.0 * np.log10(num / np.maximum(den, 1e-30))


def a_weighted_loudness(audio16k: np.ndarray, hop_length: int = 160) -> np.ndarray:
    """Per-frame A-weighted loudness (reference crepe/loudness.py:28-66)."""
    pad = WINDOW_SIZE // 2
    y = np.pad(np.asarray(audio16k, np.float32), (pad, pad))
    mag = stft_magnitude(torch.from_numpy(y)[None], WINDOW_SIZE, hop_length,
                         WINDOW_SIZE)[0].numpy()  # [T, bins]
    db = 20.0 * np.log10(np.maximum(mag, 1e-5))
    freqs = np.linspace(0, SAMPLE_RATE / 2, WINDOW_SIZE // 2 + 1)
    weighted = db + (a_weighting_db(freqs) - REF_DB)[None, :]
    weighted = np.maximum(weighted, MIN_DB)
    return weighted.mean(axis=1).astype(np.float32)[None, :]


def argmax_decode(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Plain per-frame argmax decoder (decode.py:13-18). probs [T, 360]."""
    bins = probs.argmax(axis=1)
    cents = CENTS_PER_BIN * bins + CENTS_OFFSET
    return bins, 10 * 2 ** (cents / 1200)


def weighted_argmax_decode(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Local expectation around the argmax (decode.py:21-52). probs [T, 360]."""
    bins = probs.argmax(axis=1)
    T = len(probs)
    start = np.maximum(0, bins - 4)
    end = np.minimum(PITCH_BINS, bins + 5)
    idx = np.arange(PITCH_BINS)[None, :]
    window = (idx >= start[:, None]) & (idx < end[:, None])
    masked = np.where(window, probs, 0.0)
    cents_axis = CENTS_PER_BIN * np.arange(PITCH_BINS) + CENTS_OFFSET
    cents = (masked * cents_axis[None, :]).sum(axis=1) / np.maximum(
        masked.sum(axis=1), 1e-12
    )
    return bins, 10 * 2 ** (cents / 1200)
