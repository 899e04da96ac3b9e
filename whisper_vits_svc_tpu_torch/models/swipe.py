"""SWIPE' sawtooth-waveform-inspired pitch estimator (JAX
whisper_vits_svc_tpu/models/swipe.py; the reference vendors a numpy SWIPE,
pitch/core/swipe.py, Camacho & Harris 2008):

  * candidate pitches on a log2 grid (1/96 octave);
  * sqrt-magnitude spectra at octave-spaced window sizes (optimal window
    ~ 8 fs / f), hann windows, half-window hop, each the port's matmul STFT
    on the device;
  * on the host in numpy, as in the JAX package: the spectra interpolated
    onto an ERB-spaced axis, prime-harmonic cosine kernels correlated with
    them, the blend of the two neighbouring window sizes per candidate and
    parabolic interpolation around each frame's argmax.

Returns (f0 [T], strength [T]) at the requested hop. `device` is the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.stft import stft_magnitude
from ..utils.device import resolve_device


def hz2erbs(hz):
    return 21.4 * np.log10(1.0 + np.asarray(hz, np.float64) / 229.0)


def erbs2hz(erbs):
    return (10.0 ** (np.asarray(erbs, np.float64) / 21.4) - 1.0) * 229.0


def _primes_upto(n: int) -> np.ndarray:
    sieve = np.ones(n + 1, bool)
    sieve[:2] = False
    for i in range(2, int(n**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = False
    return np.flatnonzero(sieve)


@lru_cache(maxsize=None)
def _kernels(fmin: float, fmax: float, dlog2p: float, derbs: float):
    """-> (candidate pitches [P], ERB-axis Hz [E], kernel matrix [P, E])."""
    log2p = np.arange(np.log2(fmin), np.log2(fmax), dlog2p)
    pc = 2.0**log2p
    erbs_axis = np.arange(hz2erbs(pc[0] / 4), hz2erbs(fmax * 2), derbs)
    ferbs = erbs2hz(erbs_axis)

    kernels = np.zeros((len(pc), len(ferbs)))
    primes = _primes_upto(30)
    for i, f in enumerate(pc):
        n_harm = int(min(30, np.floor(ferbs[-1] / f)))
        use = [1] + [int(p) for p in primes if p <= n_harm]
        q = ferbs / f  # harmonic number coordinate
        k = np.zeros(len(ferbs))
        for h in use:
            d = np.abs(q - h)
            # main lobe: 0.75-cosine within a quarter period; side valleys
            lobe = np.where(d < 0.25, np.cos(2 * np.pi * q), 0.0)
            lobe = lobe + np.where((0.25 <= d) & (d < 0.75),
                                   np.cos(2 * np.pi * q) / 2.0, 0.0)
            k = k + lobe
        # amplitude-normalize by 1/sqrt(f) envelope (Camacho eq. for SWIPE')
        k = k * np.sqrt(1.0 / np.maximum(ferbs, 1e-6))
        norm = np.linalg.norm(k[k > 0]) + 1e-12
        kernels[i] = k / norm
    return pc.astype(np.float64), ferbs, kernels.astype(np.float32)


def swipe(
    x: np.ndarray,
    fs: int = 16000,
    hop: int = 160,
    fmin: float = 55.0,
    fmax: float = 1000.0,
    dlog2p: float = 1.0 / 96.0,
    derbs: float = 0.1,
    strength_threshold: float = 0.2,
    device: str | torch.device | None = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n_out = 1 + len(x) // hop
    pc, ferbs, kernels = _kernels(fmin, fmax, dlog2p, derbs)

    # octave-spaced window sizes around the optimal ws = 8 fs / f
    log_ws = np.round(np.log2(8.0 * fs / np.array([fmax, fmin])))
    ws_list = (2.0 ** np.arange(log_ws[0], log_ws[1] + 1)).astype(int)
    # per-candidate fractional window index for blending
    opt = np.log2(8.0 * fs / pc)  # ideal log2 ws per candidate

    S = np.zeros((len(pc), n_out), np.float32)  # blended strength
    for wi, ws in enumerate(ws_list):
        hop_w = max(ws // 2, 1)
        pad = ws // 2
        y = np.pad(x, (pad, pad + ws))
        mag = stft_magnitude(torch.from_numpy(y)[None].to(dev), int(ws), hop_w,
                             int(ws))[0].cpu().numpy()  # [frames, bins]
        mag = np.sqrt(mag)  # sqrt-magnitude (SWIPE')
        freqs = np.linspace(0, fs / 2, ws // 2 + 1)
        # interpolate spectrum onto ERB axis
        erb_mag = np.empty((mag.shape[0], len(ferbs)), np.float32)
        for t in range(mag.shape[0]):
            erb_mag[t] = np.interp(ferbs, freqs, mag[t])
        # normalized correlation with each kernel
        denom = np.linalg.norm(erb_mag, axis=1, keepdims=True) + 1e-12
        strength = (erb_mag / denom) @ kernels.T  # [frames, P]

        # window-size blending weight per candidate
        lam = np.clip(1.0 - np.abs(opt - np.log2(ws)), 0.0, 1.0)  # [P]
        # resample this resolution's frames to the output hop
        t_axis = np.arange(mag.shape[0]) * hop_w - pad
        out_axis = np.arange(n_out) * hop
        for p in np.flatnonzero(lam > 0):
            S[p] += lam[p] * np.interp(out_axis, t_axis, strength[:, p])

    best = np.argmax(S, axis=0)
    strength = S[best, np.arange(n_out)]
    # parabolic refinement on the log2 pitch grid
    b0 = np.clip(best - 1, 0, len(pc) - 1)
    b2 = np.clip(best + 1, 0, len(pc) - 1)
    y0, y1, y2 = S[b0, np.arange(n_out)], strength, S[b2, np.arange(n_out)]
    denom = y0 - 2 * y1 + y2
    offset = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    log2f = np.log2(pc[best]) + np.clip(offset, -1, 1) * dlog2p
    f0 = (2.0**log2f).astype(np.float32)
    f0 = np.where(strength >= strength_threshold, f0, 0.0)
    return f0[: len(x) // hop + 1], strength.astype(np.float32)[: len(x) // hop + 1]
