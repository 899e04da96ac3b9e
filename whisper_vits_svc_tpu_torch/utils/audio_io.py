"""Host-side audio I/O and resampling (JAX whisper_vits_svc_tpu/utils/audio_io.py).

Reads 16-bit PCM (and float) WAVs via scipy, writes int16 WAVs, and resamples
with a polyphase Kaiser filter (scipy.signal.resample_poly, the windowed-sinc
math of the reference's resampy path).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

MAX_WAV_VALUE = 32768.0


def load_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """-> (float32 audio in [-1, 1], sr). Resamples if target_sr is given."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        audio = resample(audio, sr, target_sr)
        sr = target_sr
    return audio, sr


def save_wav(path: str, audio: np.ndarray, sr: int, peak_norm: float | None = None):
    """float32 [-1, 1] -> int16 WAV; optional peak normalisation (the
    reference's preprocessing normalises to a 0.6 peak)."""
    audio = np.asarray(audio, np.float32).squeeze()
    if peak_norm is not None:
        peak = np.abs(audio).max()
        if peak > 0:
            audio = audio / peak * peak_norm
    pcm = np.clip(audio * MAX_WAV_VALUE, -MAX_WAV_VALUE, MAX_WAV_VALUE - 1)
    wavfile.write(path, sr, pcm.astype(np.int16))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)
