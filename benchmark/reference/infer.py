"""Offline and streaming conversion with the plain synthesizer, frozen as the
benchmark's reference (svc_inference.py:77-134 of so-vits-svc 5.0 and its
block-wise form).

A song: the excitation is made once for the whole song over its F0 padded
with zeros to a whole number of 1000-frame buckets; the song is cut into
out_chunk + 2 * hop_frame windows overlapping by hop_frame, each padded
with zeros to that length; one prior-noise draw per chunk from a CPU
generator seeded with the request's seed; each chunk's output is trimmed
at the seams. A stream: each push synthesises [context | block], the
block's excitation continuing the phase carried from the last push and the
context's rolled back from it, one noise draw per push.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import N_HARMONICS, excitation


def chunk_plan(n: int, out_chunk: int, hop_frame: int):
    plan, i = [], 0
    while i < n:
        s, s_out = (0, 0) if i == 0 else (i - hop_frame, hop_frame)
        if i + out_chunk + hop_frame > n:
            e, e_out = n, None
        else:
            e, e_out = i + out_chunk + hop_frame, -hop_frame
        plan.append((s, e, s_out, e_out))
        i += out_chunk
    return plan


@torch.inference_mode()
def convert_song(model, spk, pit, ppg, vec, seed: int, device, out_chunk: int = 1000,
                 hop_frame: int = 10, noise_scale: float = 1.0, chunks_per_call: int = 8):
    """The waveform [frames * hop] (float32 numpy) of one request."""
    hop = model.hop
    n = min(len(pit), len(ppg), len(vec))
    tp = max(1000, -(-n // 1000) * 1000)
    f0 = torch.zeros((1, tp))
    f0[0, :n] = torch.from_numpy(np.asarray(pit[:n], np.float32))
    source = excitation(f0.to(device), hop, model.sr)[:, : n * hop]
    width = out_chunk + 2 * hop_frame
    plan = chunk_plan(n, out_chunk, hop_frame)
    gen = torch.Generator().manual_seed(seed)
    noise = [torch.randn((width, model.inter), generator=gen) for _ in plan]
    spk_t = torch.as_tensor(np.asarray(spk, np.float32), device=device)[None]
    pieces = []
    for g0 in range(0, len(plan), chunks_per_call):
        group = plan[g0 : g0 + chunks_per_call]
        rows = dict(ppg=[], vec=[], pit=[], src=[], len=[])
        for s, e, _, _ in group:
            pad = width - (e - s)
            rows["ppg"].append(np.pad(ppg[s:e], ((0, pad), (0, 0))))
            rows["vec"].append(np.pad(vec[s:e], ((0, pad), (0, 0))))
            rows["pit"].append(np.pad(pit[s:e], (0, pad)))
            rows["src"].append(torch.nn.functional.pad(source[0, s * hop : e * hop], (0, 0, 0, pad * hop)))
            rows["len"].append(e - s)

        def t(a):
            return torch.from_numpy(np.stack(a).astype(np.float32)).to(device)

        out = model(t(rows["ppg"]), t(rows["vec"]), t(rows["pit"]),
                    spk_t.expand(len(group), -1), torch.tensor(rows["len"], device=device),
                    torch.stack(rows["src"]), noise_scale,
                    torch.stack(noise[g0 : g0 + len(group)]).to(device))
        out = out[..., 0].cpu().numpy()
        for j, (s, e, s_out, e_out) in enumerate(group):
            w = out[j, : (e - s) * hop]
            pieces.append(w[s_out * hop : None if e_out is None else e_out * hop])
    return np.concatenate(pieces)


@torch.inference_mode()
def convert_stream(model, spk, ppg, vec, pit, n_pushes: int, seed: int, device,
                   block: int = 100, context: int = 50, noise_scale: float = 1.0,
                   blocks_per_call: int = 32):
    """The audio of each of the first `n_pushes` full blocks of the stream
    (features [n_pushes * block, C]), as a list of float32 numpy arrays."""
    hop, sr, total = model.hop, model.sr, context + block
    ppg = np.concatenate([np.zeros((context, ppg.shape[1]), np.float32), ppg])
    vec = np.concatenate([np.zeros((context, vec.shape[1]), np.float32), vec])
    pit = np.concatenate([np.zeros(context, np.float32), pit])
    gen = torch.Generator().manual_seed(seed)
    harmonics = torch.arange(1, N_HARMONICS + 1, device=device)
    phase = torch.zeros((1, N_HARMONICS), device=device)
    sources, noises = [], []
    for k in range(n_pushes):
        noises.append(torch.randn((1, total, model.inter), generator=gen)[0])
        p = torch.from_numpy(pit[k * block : k * block + total])[None].to(device)
        new, phase_next = excitation(p[:, context:], hop, sr, phase0=phase, return_phase=True)
        inc = torch.sum(p[:, :context, None] * harmonics * (hop / sr), dim=1)
        back = phase - (inc - torch.floor(inc))
        ctx = excitation(p[:, :context], hop, sr, phase0=back - torch.floor(back))
        sources.append(torch.cat([ctx, new], dim=1)[0])
        phase = phase_next
    spk_t = torch.as_tensor(np.asarray(spk, np.float32), device=device)[None]
    out = []
    for k0 in range(0, n_pushes, blocks_per_call):
        ks = range(k0, min(n_pushes, k0 + blocks_per_call))

        def rows(a):
            return torch.from_numpy(np.stack([a[k * block : k * block + total] for k in ks])
                                    .astype(np.float32)).to(device)

        y = model(rows(ppg), rows(vec), rows(pit), spk_t.expand(len(ks), -1),
                  torch.full((len(ks),), total, device=device),
                  torch.stack([sources[k] for k in ks]), noise_scale,
                  torch.stack([noises[k] for k in ks]).to(device))
        out.extend(y[:, context * hop :, 0].cpu().numpy())
    return out
