"""Praat-style autocorrelation pitch tracking (Boersma 1993).

A copy of the JAX package's models/praat.py, which is numpy only: it runs
on the host in both packages, and the port keeps its own copy so that it
imports nothing of that package.

The reference's `pitch/inference.py:14-28` and `prepare/preprocess_f0_mouth.py`
shell out to the parselmouth C++ binding (`Sound.to_pitch_ac(time_step=10ms,
voicing_threshold=0.5, pitch_floor=30, pitch_ceiling=1000)`). This implements
the same algorithm from the paper ("Accurate short-term analysis of the
fundamental frequency and the harmonics-to-noise ratio of a sampled sound"):

  * per frame: local-mean-subtracted Hanning-windowed segment, normalized
    autocorrelation divided by the window's own autocorrelation,
  * voiced candidates at local maxima with parabolic lag refinement and
    strength R = r(tau) - octave_cost * log2(floor * tau),
  * an unvoiced candidate with strength
    vth + max(0, 2 - (local_peak/global_peak) / (sth/(1+vth))),
  * Viterbi over candidates with octave-jump and voiced/unvoiced costs.

All frame autocorrelations are computed as ONE batched rFFT (power spectrum)
per utterance. Deviation (documented): praat refines lags by sinc
interpolation of the autocorrelation; parabolic refinement is used here.
"""

from __future__ import annotations

import numpy as np


def to_pitch_ac(
    x: np.ndarray,
    fs: int = 16000,
    time_step: float = 0.01,
    voicing_threshold: float = 0.5,
    pitch_floor: float = 30.0,
    pitch_ceiling: float = 1000.0,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    max_candidates: int = 15,
    periods_per_window: float = 3.0,
) -> np.ndarray:
    """-> f0 [n_frames] (0 = unvoiced), frames every `time_step` seconds.

    Frame layout follows praat's short-term analysis: windows of
    periods_per_window/pitch_floor seconds, centered so the frame grid is
    symmetric inside the utterance.
    """
    x = np.asarray(x, np.float64)
    win_len = int(round(periods_per_window / pitch_floor * fs))
    win_len -= win_len % 2  # even, praat uses half-window symmetric segments
    hop = int(round(time_step * fs))
    if len(x) < win_len + 1:
        return np.zeros(0, np.float32)
    n_frames = (len(x) - win_len) // hop + 1
    t0 = (len(x) - ((n_frames - 1) * hop + win_len)) // 2

    starts = t0 + np.arange(n_frames) * hop
    frames = x[starts[:, None] + np.arange(win_len)[None, :]]
    frames = frames - frames.mean(axis=1, keepdims=True)

    global_peak = np.abs(x - x.mean()).max() + 1e-30
    window = np.hanning(win_len)
    wframes = frames * window
    local_peak = np.abs(wframes).max(axis=1)

    # batched normalized autocorrelation via one rFFT (Boersma eq. 6-9)
    lag_min = max(int(fs / pitch_ceiling), 2)
    lag_max = min(int(np.ceil(fs / pitch_floor)), win_len - 1)
    n_fft = 1 << int(np.ceil(np.log2(2 * win_len)))
    ps = np.abs(np.fft.rfft(wframes, n_fft, axis=1)) ** 2
    ac = np.fft.irfft(ps, n_fft, axis=1)[:, : lag_max + 2]
    r = ac / np.maximum(ac[:, :1], 1e-30)
    wac = np.fft.irfft(np.abs(np.fft.rfft(window, n_fft)) ** 2, n_fft)
    rw = (wac / wac[0])[: lag_max + 2]
    r = r / np.maximum(rw[None, :], 1e-12)

    # voiced candidates: local maxima of r in [lag_min, lag_max]
    seg = r[:, lag_min : lag_max + 1]
    left, right = r[:, lag_min - 1 : lag_max], r[:, lag_min + 1 : lag_max + 2]
    is_peak = (seg > left) & (seg >= right) & (seg > 0.0)

    # assemble per-frame candidate tables: freq 0 == the unvoiced candidate
    cand_f = np.zeros((n_frames, max_candidates))
    cand_s = np.full((n_frames, max_candidates), -np.inf)
    sth_term = silence_threshold / (1.0 + voicing_threshold)
    cand_s[:, 0] = voicing_threshold + np.maximum(
        0.0, 2.0 - (local_peak / global_peak) / sth_term)
    for i in range(n_frames):
        peaks = np.nonzero(is_peak[i])[0]
        if len(peaks) == 0:
            continue
        tau = peaks + lag_min
        # parabolic lag refinement
        y0, y1, y2 = r[i, tau - 1], r[i, tau], r[i, tau + 1]
        denom = y0 - 2 * y1 + y2
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
        tau_ref = tau + np.clip(delta, -0.5, 0.5)
        rmax = y1 - 0.25 * (y0 - y2) * delta
        strength = rmax - octave_cost * np.log2(pitch_floor * tau_ref / fs)
        order = np.argsort(strength)[::-1][: max_candidates - 1]
        k = len(order)
        cand_f[i, 1 : 1 + k] = fs / tau_ref[order]
        cand_s[i, 1 : 1 + k] = strength[order]
    cand_f[cand_f > pitch_ceiling] = 0.0

    # Viterbi over candidate columns (Boersma section 4)
    def trans_cost(f_prev: np.ndarray, f_cur: np.ndarray) -> np.ndarray:
        fp, fc = f_prev[:, None], f_cur[None, :]
        both = (fp > 0) & (fc > 0)
        onev = (fp > 0) ^ (fc > 0)
        cost = np.where(onev, voiced_unvoiced_cost, 0.0)
        safe = np.where(both, fp / np.maximum(fc, 1e-12), 1.0)
        return cost + np.where(both, octave_jump_cost * np.abs(np.log2(safe)), 0.0)

    score = cand_s[0].copy()
    ptr = np.zeros((n_frames, max_candidates), np.int64)
    for i in range(1, n_frames):
        total = score[:, None] - trans_cost(cand_f[i - 1], cand_f[i])
        ptr[i] = np.argmax(total, axis=0)
        score = total[ptr[i], np.arange(max_candidates)] + cand_s[i]
    path = np.empty(n_frames, np.int64)
    path[-1] = int(np.argmax(score))
    for i in range(n_frames - 2, -1, -1):
        path[i] = ptr[i + 1, path[i + 1]]
    return cand_f[np.arange(n_frames), path].astype(np.float32)


def compute_f0_mouth(x: np.ndarray, fs: int = 16000, hop: int = 160) -> np.ndarray:
    """`.pit.npy`-compatible wrapper matching pitch/inference.py:14-28:
    praat-AC pitch at 10 ms steps, zero-padded 1024//hop frames each side."""
    f0 = to_pitch_ac(np.asarray(x, np.float32), fs, time_step=hop / fs,
                     voicing_threshold=0.5, pitch_floor=30.0,
                     pitch_ceiling=1000.0)
    pad = 1024 // hop
    f0 = np.pad(f0, (pad, pad))
    n = 1 + len(x) // hop
    if len(f0) < n:
        f0 = np.pad(f0, (0, n - len(f0)))
    return f0[:n].astype(np.float32)
