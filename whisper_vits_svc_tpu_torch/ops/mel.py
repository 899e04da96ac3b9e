"""Mel filterbank constants (slaney scale / slaney norm, librosa-compatible),
a numpy copy of whisper_vits_svc_tpu/ops/mel.py (the reference's
librosa.filters.mel call sites: vits_extend/stft.py:50 et al.).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_F_SP = 200.0 / 3.0          # slaney: linear region Hz per mel
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asanyarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asanyarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2 + 1], float32.

    Default: slaney scale + slaney area norm == librosa.filters.mel defaults.
    htk=True, norm=None matches torchaudio.transforms.MelSpectrogram defaults
    (used by the reference's MED discriminator, vits_decoder/med.py:13).
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float64)

    to_mel = hz_to_mel_htk if htk else hz_to_mel
    to_hz = mel_to_hz_htk if htk else mel_to_hz
    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        # slaney normalization: each filter has ~unit area
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)
