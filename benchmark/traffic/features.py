"""Seeded traffic of every driver, from the parameters of a workload file.

Sizes come from the parameters alone, so every seed gets the same set of
song lengths, stream and batch shapes; the seed draws the content (features,
F0 contours, speakers, the noise streams). Features are made on the device
in a few large draws and, where the program takes host arrays, copied to the
host once, each feature a contiguous array as a feature file loads.

F0 contours follow the program's smoke test (chip_smoke.py `features`): a
sung line around a base pitch with a two-octave sweep, vibrato, and an
unvoiced run of 40 frames in every 300.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for stream `keys` of run `seed` (any whole number)."""
    return int(np.random.SeedSequence([seed % 2**64, *keys]).generate_state(1, np.uint64)[0] >> 1)


def stratified(lo: float, hi: float, n: int, log: bool = False) -> np.ndarray:
    """n sizes at the midpoints of n equal strata of [lo, hi] (of log space)."""
    q = (np.arange(n) + 0.5) / n
    return np.exp(np.log(lo) + q * np.log(hi / lo)) if log else lo + q * (hi - lo)


def f0_contour(frames: int, base: float, offset: int) -> np.ndarray:
    t = np.arange(frames) + offset
    pit = base * 2 ** np.sin(2 * np.pi * t / 400.0) * (1 + 0.02 * np.sin(t / 3.0))
    pit[(t % 300) >= 260] = 0.0
    return pit.astype(np.float32)


def _normal(gen, shape, scale, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * scale


def song_pool(model_cfg: dict, p: dict, seed: int, device) -> list[dict]:
    """p: songs, min_frames, max_frames. Each song: spk [spk_dim], pit [T],
    ppg [T, ppg_dim], vec [T, vec_dim] as float32 numpy."""
    v = model_cfg["vits"]
    lengths = stratified(p["min_frames"], p["max_frames"], p["songs"]).astype(int)
    rng = np.random.default_rng(sub_seed(seed, 1))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    songs = []
    for n in lengths:
        feats = _normal(gen, (int(n), v["ppg_dim"] + v["vec_dim"]), 0.5, device).cpu().numpy()
        spk = _normal(gen, (v["spk_dim"],), v["spk_dim"] ** -0.5, device).cpu().numpy()
        songs.append(dict(spk=spk, ppg=np.ascontiguousarray(feats[:, : v["ppg_dim"]]),
                          vec=np.ascontiguousarray(feats[:, v["ppg_dim"] :]),
                          pit=f0_contour(int(n), float(rng.uniform(110, 330)),
                                         int(rng.integers(0, 1200)))))
    return songs


def stream(model_cfg: dict, p: dict, seed: int, device) -> dict:
    """p: stream_blocks, block_frames. One recorded stream, replayed in a
    loop: spk and features of stream_blocks * block_frames frames."""
    v = model_cfg["vits"]
    n = p["stream_blocks"] * p["block_frames"]
    rng = np.random.default_rng(sub_seed(seed, 1))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    feats = _normal(gen, (n, v["ppg_dim"] + v["vec_dim"]), 0.5, device).cpu().numpy()
    spk = _normal(gen, (v["spk_dim"],), v["spk_dim"] ** -0.5, device).cpu().numpy()
    return dict(spk=spk, ppg=np.ascontiguousarray(feats[:, : v["ppg_dim"]]),
                vec=np.ascontiguousarray(feats[:, v["ppg_dim"] :]),
                pit=f0_contour(n, float(rng.uniform(110, 330)), int(rng.integers(0, 1200))))


def batch_plan(p: dict) -> list[int]:
    """Padded frames of each batch of the pool: p utterances (count,
    log-uniform between min_frames and max_frames), bucket_frames, batch.
    Each utterance goes to the bucket its length rounds up to, a bucket is
    filled up to whole batches by repeating its utterances, as the program's
    BucketBatcher does, and every batch is padded to its bucket's bound. The
    pool's order interleaves short and long batches (bit-reversed order of
    the batches sorted by length), so that any run of steps sees the mix."""
    lengths = stratified(p["min_frames"], p["max_frames"], p["utterances"], log=True)
    step, b = p["bucket_frames"], p["batch"]
    buckets: dict[int, int] = {}
    for n in lengths:
        top = int(math.ceil(n / step) * step)
        buckets[top] = buckets.get(top, 0) + 1
    sizes = sorted(t for t, count in buckets.items() for _ in range(-(-count // b)))
    bits = max(1, (len(sizes) - 1).bit_length())
    order = sorted(range(len(sizes)), key=lambda i: int(f"{i:0{bits}b}"[::-1], 2))
    return [sizes[i] for i in order]


def train_pool(model_cfg: dict, p: dict, seed: int, device) -> list[dict]:
    """Batches on the device with the program's batch keys: ppg, vec [B, T,
    C] and pit [B, T] (Hz 100-400), spec [B, T, bins] (|normal|), spk
    [B, spk_dim], audio [B, T * hop, 1], each zero past its utterance's
    length, and ppg_l = spec_l the lengths (int32). Lengths inside a batch
    are drawn between the bucket's lower bound and its top."""
    v, d = model_cfg["vits"], model_cfg["data"]
    hop, bins, b = d["hop_length"], d["filter_length"] // 2 + 1, p["batch"]
    rng = np.random.default_rng(sub_seed(seed, 1))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    pool = []
    for t in batch_plan(p):
        lo = max(p["min_frames"], t - p["bucket_frames"] + 1, d["segment_size"] // hop)
        lens = torch.from_numpy(rng.integers(lo, t + 1, b).astype(np.int32)).to(device)
        mask = (torch.arange(t, device=device)[None, :] < lens[:, None]).float()
        batch = dict(
            ppg=_normal(gen, (b, t, v["ppg_dim"]), 0.1, device) * mask[..., None],
            vec=_normal(gen, (b, t, v["vec_dim"]), 0.1, device) * mask[..., None],
            pit=(100.0 + 300.0 * torch.rand((b, t), generator=gen, device=device)) * mask,
            spk=_normal(gen, (b, v["spk_dim"]), 1.0, device),
            spec=_normal(gen, (b, t, bins), 1.0, device).abs() * mask[..., None],
            audio=(_normal(gen, (b, t * hop), 0.2, device)
                   * mask.repeat_interleave(hop, dim=1))[..., None],
            ppg_l=lens, spec_l=lens.clone())
        pool.append(batch)
    return pool
