"""Harmonic-plus-noise NSF excitation source (reference vits_decoder/nsf.py
SineGen / SourceModuleHnNSF).

Phase is computed hierarchically and exactly, as the JAX package does
(whisper_vits_svc_tpu/nn/nsf.py:73-99): the per-frame increment hop*f0/sr
loses its integer part (phase-invariant mod 1), a frame-level exclusive
cumsum of the fractions gives each frame's start phase, and a within-frame
ramp adds the rest. No sample-rate cumsum, and less float error than the
reference's full-length one.

Input is frame-rate F0 [B, T_frames]; output is sample-rate [B, T*hop, ...].
"""

from __future__ import annotations

import math

import torch

from ..utils import rng as draws

# Fixed harmonic-merge weights of the reference (vits_decoder/nsf.py:378-381).
MERGE_W = (0.2942, -0.2243, 0.0033, -0.0056, -0.0020, -0.0046,
           0.0221, -0.0083, -0.0241, -0.0036, -0.0581)
MERGE_B = 0.0008


def sine_harmonics(f0_frames: torch.Tensor, hop: int, sampling_rate: int,
                   harmonic_num: int = 10, sine_amp: float = 0.1,
                   noise_std: float = 0.003, voiced_threshold: float = 0.0,
                   rng: torch.Generator | None = None,
                   phase0: torch.Tensor | None = None,
                   return_phase: bool = False):
    """[B, T_frames] F0 -> [B, T_frames*hop, harmonic_num+1] gated sines.

    rng=None is the deterministic mode: no random initial phases and no
    noise. Otherwise `rng` (a torch.Generator on f0's device) draws them.
    phase0 [B, harmonic_num+1] carries the fractional phase (in cycles) from
    a previous block; return_phase also returns the end-of-block phase, so
    block-wise generation equals whole-utterance generation.
    """
    b, t = f0_frames.shape
    dim = harmonic_num + 1
    dev = f0_frames.device
    f0 = f0_frames.float()[..., None]  # [B, T, 1]
    f_h = f0 * torch.arange(1, dim + 1, dtype=torch.float32, device=dev)

    inc = f_h * (hop / sampling_rate)
    inc_frac = inc - torch.floor(inc)
    csum = torch.cumsum(inc_frac, dim=1)
    zeros = torch.zeros(b, 1, dim, device=dev)
    start = zeros if phase0 is None else phase0.float()[:, None, :]
    frame_base = start + torch.cat([zeros, csum[:, :-1]], dim=1)
    frame_base = frame_base - torch.floor(frame_base)
    phase_end = start[:, 0] + csum[:, -1]
    phase_end = phase_end - torch.floor(phase_end)

    if rng is not None:
        rand_ini = draws.rand((b, 1, dim), rng, device=dev)
        rand_ini[:, :, 0] = 0.0  # fundamental pinned (nsf.py:235)
        frame_base = frame_base + rand_ini

    # the reference cumsum is inclusive: sample s of a frame sits s+1
    # increments past the frame base
    ramp = torch.arange(1, hop + 1, dtype=torch.float32, device=dev)
    phase = frame_base[:, :, None, :] + ramp[None, None, :, None] * (
        f_h[:, :, None, :] / sampling_rate)
    sines = torch.sin(2.0 * math.pi * phase).reshape(b, t * hop, dim) * sine_amp

    uv = (f0_frames > voiced_threshold).float()
    uv = torch.repeat_interleave(uv, hop, dim=1)[..., None]  # [B, T*hop, 1]
    out = sines * uv
    if rng is not None:
        noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
        out = out + noise_amp * draws.randn(sines.shape, rng, device=dev)
    if return_phase:
        return out, phase_end
    return out


def source_hn_nsf(f0_frames: torch.Tensor, hop: int, sampling_rate: int,
                  rng: torch.Generator | None = None, sine_amp: float = 0.1,
                  noise_std: float = 0.003, voiced_threshold: float = 0.0,
                  phase0: torch.Tensor | None = None, return_phase: bool = False):
    """[B, T_frames] -> [B, T_frames*hop, 1] merged excitation: the fixed
    11 -> 1 linear merge and tanh of SourceModuleHnNSF (nsf.py:383-394)."""
    sines = sine_harmonics(f0_frames, hop, sampling_rate, 10, sine_amp, noise_std,
                           voiced_threshold, rng, phase0=phase0,
                           return_phase=return_phase)
    if return_phase:
        sines, phase_end = sines
    w = torch.tensor(MERGE_W, dtype=torch.float32, device=f0_frames.device)
    out = torch.tanh(sines @ w[:, None] + MERGE_B)
    if return_phase:
        return out, phase_end
    return out
