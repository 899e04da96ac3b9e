"""A seeded synthetic recording at 16 kHz for the live cells that take a
wave: sung phrases with rests between them, replayed in a loop.

A phrase lasts 2-6 s: a harmonic tone whose f0 is log-uniform over
110-660 Hz, with a 5.5 Hz vibrato of +-40 cents, 20-30 harmonics (those
under the Nyquist frequency) falling at 6-12 dB an octave, 20 ms fades at
both ends, and breath noise 30 dB under the tone. Between phrases, 0.3-1.0 s
of white noise at -60 dBFS. The phrases are scaled so that the loudest
sample is 0.5. The draws are made on the host from the seed, the sum of
harmonics on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .features import sub_seed

SR = 16000


def recording(p: dict, seed: int, device) -> np.ndarray:
    """p: recording_seconds. [recording_seconds * 16000] float32."""
    n = int(round(p["recording_seconds"] * SR))
    rng = np.random.default_rng(sub_seed(seed, 11))
    out = torch.zeros(n, dtype=torch.float64, device=device)
    voiced = torch.zeros(n, dtype=torch.bool, device=device)
    start = int(rng.uniform(0.3, 1.0) * SR)
    while start < n:
        length = min(int(rng.uniform(2.0, 6.0) * SR), n - start)
        f0 = math.exp(rng.uniform(math.log(110.0), math.log(660.0)))
        harmonics = int(rng.integers(20, 31))
        tilt = rng.uniform(1.0, 2.0)  # amplitude ~ k^-tilt: 6-12 dB an octave
        vib_phase = rng.uniform(0.0, 2 * math.pi)
        t = torch.arange(length, dtype=torch.float64, device=device) / SR
        hz = f0 * 2.0 ** (40.0 / 1200.0 * torch.sin(2 * math.pi * 5.5 * t + vib_phase))
        phase = 2 * math.pi * torch.cumsum(hz, 0) / SR
        k = torch.arange(1, harmonics + 1, dtype=torch.float64, device=device)
        amp = k ** -tilt * (k * f0 * 2.0 ** (40.0 / 1200.0) < SR / 2)
        tone = (amp[:, None] * torch.sin(k[:, None] * phase[None])).sum(0)
        fade = torch.clamp(torch.minimum(t, t[-1] - t) / 0.02, max=1.0)
        breath = torch.from_numpy(rng.standard_normal(length)).to(device)
        tone = tone / tone.abs().max()
        out[start : start + length] = fade * (tone + 10 ** (-30 / 20) * breath)
        voiced[start : start + length] = True
        start += length + int(rng.uniform(0.3, 1.0) * SR)
    out = out * (0.5 / out.abs().max())
    rest = torch.from_numpy(rng.standard_normal(n) * 10 ** (-60 / 20)).to(device)
    out = torch.where(voiced, out, rest)
    return out.float().cpu().numpy()
