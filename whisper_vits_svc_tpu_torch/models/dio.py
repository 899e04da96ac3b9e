"""DIO + StoneMask F0 estimation (WORLD vocoder), dependency-free.

A copy of the JAX package's models/dio.py, which is numpy only: it runs on
the host in both packages, and the port keeps its own copy so that it
imports nothing of that package.

The reference's alternative preprocessing path shells out to the pyworld C++
binding (`prepare/preprocess_f0.py:14-21`: `pyworld.dio(x, fs=16000,
f0_ceil=900, frame_period=10ms)` followed by `pyworld.stonemask`). SURVEY.md
§2.9 lists pyworld as a native component to replace. This is a from-scratch
implementation of the two algorithms (Morise et al., DIO 2009 / StoneMask as
shipped in WORLD), organized in batches:

  * all band-pass filtering happens in ONE batched frequency-domain multiply —
    the signal is FFT'd once and every candidate band's nuttall low-pass is
    applied as a [n_bands, n_fft] broadcast (the WORLD C code loops bands and
    re-runs FFTs),
  * event detection (zero crossings / peaks / dips of each filtered band) and
    the contour fix-up are host-side NumPy — data-dependent event counts, on
    an offline preprocessing path.

Simplifications vs WORLD, documented: no decimation (speed=1, which is what
the reference passes), and the contour fix keeps steps 1-2 (outlier + short
voiced-run removal) plus a single candidate-based boundary extension pass
instead of WORLD's four-step forward/backward loop.
"""

from __future__ import annotations

import numpy as np

_CUTOFF_HZ = 50.0  # WORLD kCutOff low-cut


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * 2.0 * np.pi / (n - 1)
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _zero_crossings(x: np.ndarray, fs: float) -> np.ndarray:
    """Times (sec) of negative-going zero crossings, linearly interpolated."""
    idx = np.nonzero((x[:-1] > 0.0) & (x[1:] <= 0.0))[0]
    if len(idx) == 0:
        return np.empty(0)
    frac = x[idx] / (x[idx] - x[idx + 1])
    return (idx + frac) / fs


def _interval_f0(times: np.ndarray, frame_t: np.ndarray) -> np.ndarray:
    """Event times -> interval-based F0 sampled at frame times (0 outside)."""
    if len(times) < 3:
        return np.zeros(len(frame_t))
    mid = 0.5 * (times[1:] + times[:-1])
    f0 = 1.0 / np.diff(times)
    out = np.interp(frame_t, mid, f0, left=0.0, right=0.0)
    out[(frame_t < mid[0]) | (frame_t > mid[-1])] = 0.0
    return out


def _band_candidates(band: np.ndarray, fs: float, frame_t: np.ndarray,
                     boundary_f0: float, f0_floor: float, f0_ceil: float
                     ) -> tuple[np.ndarray, np.ndarray]:
    """F0 candidate + reliability score for one filtered band.

    WORLD's GetFourZeroCrossingIntervals: negative/positive zero crossings of
    the signal and of its derivative (peaks/dips); candidate = mean of the
    four interval-F0s, score = stddev across them (lower = more periodic).
    """
    d = np.diff(band)
    ests = np.stack([
        _interval_f0(_zero_crossings(band, fs), frame_t),
        _interval_f0(_zero_crossings(-band, fs), frame_t),
        _interval_f0(_zero_crossings(d, fs), frame_t),
        _interval_f0(_zero_crossings(-d, fs), frame_t),
    ])
    cand = ests.mean(axis=0)
    score = ests.std(axis=0)
    bad = ((ests <= 0.0).any(axis=0)
           | (cand > boundary_f0) | (cand < boundary_f0 / 2.0)
           | (cand > f0_ceil) | (cand < f0_floor))
    cand = np.where(bad, 0.0, cand)
    score = np.where(bad, np.inf, score / np.maximum(cand, 1e-12))
    return cand, score


def _fix_contour(f0: np.ndarray, candidates: np.ndarray, frame_period_s: float,
                 f0_floor: float, allowed_range: float) -> np.ndarray:
    """Steps 1-2 of WORLD's FixF0Contour + one candidate extension pass."""
    out = f0.copy()
    # step 1: zero frames whose relative jump from the previous frame exceeds
    # allowed_range (WORLD FixStep1)
    prev = out[:-1]
    jump = np.abs(out[1:] - prev) / np.maximum(prev, 1e-12)
    out[1:] = np.where((prev > 0) & (out[1:] > 0) & (jump > allowed_range),
                       0.0, out[1:])
    # step 2: drop voiced runs shorter than voice_range_minimum frames
    vrm = int(0.5 + 1.0 / frame_period_s / f0_floor) * 2 + 1
    voiced = out > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], voiced.view(np.int8), [0]])))
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s < vrm:
            out[s:e] = 0.0
    # extension pass (steps 3-4, simplified): grow each voiced run into
    # adjacent unvoiced frames by picking the band candidate closest to the
    # edge value while it stays within allowed_range
    voiced = out > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], voiced.view(np.int8), [0]])))
    for s, e in zip(edges[::2], edges[1::2]):
        ref = out[s]
        for i in range(s - 1, -1, -1):
            if out[i] > 0:
                break
            c = candidates[:, i]
            j = np.argmin(np.abs(c - ref) + np.where(c > 0, 0.0, np.inf))
            if c[j] <= 0 or abs(c[j] - ref) / ref > allowed_range:
                break
            out[i] = ref = c[j]
        ref = out[e - 1]
        for i in range(e, len(out)):
            if out[i] > 0:
                break
            c = candidates[:, i]
            j = np.argmin(np.abs(c - ref) + np.where(c > 0, 0.0, np.inf))
            if c[j] <= 0 or abs(c[j] - ref) / ref > allowed_range:
                break
            out[i] = ref = c[j]
    return out


def dio(
    x: np.ndarray,
    fs: int = 16000,
    f0_floor: float = 71.0,
    f0_ceil: float = 900.0,
    channels_in_octave: float = 2.0,
    frame_period_ms: float = 10.0,
    allowed_range: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (f0 [T], frame times [T] sec); T = 1 + len(x)*1000/(fs*period_ms).

    Defaults mirror the pyworld call in prepare/preprocess_f0.py:14-19.
    """
    x = np.asarray(x, np.float64)
    frame_period_s = frame_period_ms / 1000.0
    n_frames = int(len(x) / fs / frame_period_s) + 1
    frame_t = np.arange(n_frames) * frame_period_s

    n_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundary_f0 = f0_floor * 2.0 ** ((np.arange(n_bands) + 1) / channels_in_octave)

    # one FFT of the low-cut signal; every band filter is a spectral multiply
    margin = int(fs / _CUTOFF_HZ) * 2 + int(4 * (1 + fs / boundary_f0[0] / 2))
    n_fft = 1 << int(np.ceil(np.log2(len(x) + margin)))
    spec = np.fft.rfft(x - x.mean(), n_fft)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    # low-cut: complement of a hanning-windowed moving average at 50 Hz
    lc_len = int(round(fs / _CUTOFF_HZ)) * 2 + 1
    w = np.hanning(lc_len)
    lc = np.fft.rfft(w / w.sum(), n_fft)
    # zero-phase magnitude response of the smoother; high-pass = 1 - |H|
    spec = spec * (1.0 - np.abs(lc))

    candidates = np.zeros((n_bands, n_frames))
    scores = np.full((n_bands, n_frames), np.inf)
    for b in range(n_bands):
        half = int(round(fs / boundary_f0[b] / 2.0))
        fir = _nuttall(4 * half)
        h = np.fft.rfft(fir / fir.sum(), n_fft)
        band = np.fft.irfft(spec * np.abs(h), n_fft)[: len(x)]
        candidates[b], scores[b] = _band_candidates(
            band, fs, frame_t, boundary_f0[b], f0_floor, f0_ceil)

    best = np.argmin(scores, axis=0)
    f0 = candidates[best, np.arange(n_frames)]
    f0 = _fix_contour(f0, candidates, frame_period_s, f0_floor, allowed_range)
    return f0, frame_t


def stonemask(x: np.ndarray, f0: np.ndarray, frame_t: np.ndarray,
              fs: int = 16000) -> np.ndarray:
    """Refine a DIO contour by harmonic-weighted instantaneous frequency.

    WORLD's StoneMask: window 3 periods around each frame center, measure the
    instantaneous frequency at harmonics 1..6 of the current estimate via the
    phase derivative of the DFT, and replace F0 with the amplitude-weighted
    mean of IF/harmonic. Two refinement passes, estimates drifting out of
    [f0/2, 2*f0] (or the analysis band) are zeroed like WORLD's range check.
    """
    x = np.asarray(x, np.float64)
    out = np.asarray(f0, np.float64).copy()
    for _ in range(2):
        refined = out.copy()
        for i, (t0, cur) in enumerate(zip(frame_t, out)):
            if cur <= 0:
                continue
            half = int(1.5 * fs / cur + 0.5)
            c = int(t0 * fs + 0.5)
            lo, hi = c - half, c + half + 1
            if lo < 0 or hi > len(x) or half < 2:
                continue
            seg = x[lo:hi] * np.hanning(hi - lo)
            n = len(seg)
            harm = cur * np.arange(1, 7)
            # single-bin DFTs at the harmonics and at +1 sample shift
            ph = -2j * np.pi * np.outer(harm, np.arange(n)) / fs
            base = np.exp(ph) @ seg
            shift = np.exp(ph) @ np.roll(seg, -1)
            # instantaneous frequency from the one-sample phase increment
            dphi = np.angle(shift * np.conj(base))
            inst = dphi * fs / (2.0 * np.pi)
            k = np.arange(1, 7)
            ok = (inst > 0) & (np.abs(inst / k - cur) < 0.5 * cur)
            if not ok.any():
                continue
            wgt = np.abs(base) * ok
            est = float((inst / k * wgt).sum() / (wgt.sum() + 1e-12))
            if 0.5 * cur < est < 2.0 * cur:
                refined[i] = est
        out = refined
    return out


def compute_f0_dio(x: np.ndarray, fs: int = 16000, hop: int = 160,
                   f0_ceil: float = 900.0) -> np.ndarray:
    """`.pit.npy`-compatible wrapper matching prepare/preprocess_f0.py:10-22:
    DIO at frame_period = hop/fs, StoneMask refinement, rounded to 0.1 Hz."""
    f0, t = dio(x, fs, f0_ceil=f0_ceil, frame_period_ms=1000.0 * hop / fs)
    f0 = stonemask(x, f0, t, fs)
    return np.round(f0, 1).astype(np.float32)
