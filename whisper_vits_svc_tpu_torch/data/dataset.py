"""Training dataset and bucketed batching (JAX whisper_vits_svc_tpu/data/dataset.py;
reference vits/data_utils.py:17-325, vits_extend/dataloader.py:7-37).

  * items are kept at 1-4 s of usable frames (data_utils.py:30-31), longer
    ones cropped at load;
  * 320-hop whisper/hubert features are frame-repeated x2 to the 160-hop rate
    (data_utils.py:85-87);
  * each epoch, items are length-bucketed (the reference's [150, 300, 450],
    dataloader.py:13, scaled from the segment length) and every batch is
    zero-padded to its bucket's upper bound;
  * the buckets are shuffled from the epoch's seed, each cut to a multiple
    of the global batch (num_replicas x batch_size) and each rank keeps
    rank::num_replicas of it (the reference's DistributedBucketSampler,
    data_utils.py:289): rank r's j-th batch is rows [r*B, (r+1)*B) of the
    j-th global batch.

The draws come from `np.random.default_rng` in the JAX package's order, so
the batch order, the crops and the padded batches equal the JAX package's to
the bit. Batches are numpy dicts in [B, T, C] layout; `train/step.py` moves
them to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.audio_io import load_wav
from . import native_loader as nl


def load_filelist(path: str) -> list[list[str]]:
    with open(path, encoding="utf-8") as f:
        return [line.strip().split("|") for line in f if line.strip()]


def _load_array(path: str) -> np.ndarray:
    """.npy, or a torch .pt tensor (the reference's spec cache, data_utils.py:81)."""
    if path.endswith(".pt"):
        import torch

        return torch.load(path, map_location="cpu", weights_only=True).numpy()
    return np.load(path)


# usable length limits in segments: 1 s and 4 s at base.yaml's 25-frame
# segment (data_utils.py:30-31)
MIN_SEGMENTS = 4
MAX_SEGMENTS = 16


@dataclass
class SvcItem:
    wav: str
    spec: str
    pitch: str
    vec: str
    ppg: str
    spk: str
    frames: int   # usable length in hop_length frames


class SvcDataset:
    """File-backed dataset over the data_svc/ caches."""

    def __init__(self, filelist: str, hp_data):
        self.hp = hp_data
        self.hop = hp_data.hop_length
        self.sr = hp_data.sampling_rate
        seg_frames = hp_data.segment_size // hp_data.hop_length
        self.min_frames = seg_frames * MIN_SEGMENTS
        self.max_frames = seg_frames * MAX_SEGMENTS
        self.items: list[SvcItem] = []
        for row in load_filelist(filelist):
            wav, spec, pitch, vec, ppg, spk = row[:6]
            if not all(os.path.isfile(p) for p in row[:6]):
                continue
            usel = int(np.load(pitch, mmap_mode="r").shape[0]) - 1
            if usel < self.min_frames:
                continue
            usel = min(usel, self.max_frames)
            self.items.append(SvcItem(wav, spec, pitch, vec, ppg, spk, usel))
        self.lengths = [it.frames for it in self.items]

    def __len__(self):
        return len(self.items)

    def get(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        """One example, randomly cropped to its usable length (from the
        start without `rng`). The npy reads of the item go through the
        native loader's thread pool where it builds, else numpy."""
        it = self.items[idx]
        npy_paths = [it.pitch, it.vec, it.ppg, it.spk]
        spec_is_npy = it.spec.endswith(".npy")
        if spec_is_npy:
            npy_paths.append(it.spec)
        loaded = nl.load_npy_batch(npy_paths)
        nat_wav = nl.load_wav_native(it.wav, sr_hint=self.sr)
        audio, sr = nat_wav if nat_wav is not None else load_wav(it.wav)
        assert sr == self.sr, f"{it.wav}: {sr} != {self.sr}"
        spec = (loaded[4] if spec_is_npy and loaded[4] is not None
                else _load_array(it.spec))
        if spec.shape[0] == self.hp.filter_length // 2 + 1:
            spec = spec.T  # reference layout [bins, T] -> [T, bins]

        def _npy(i, path):
            return loaded[i] if loaded[i] is not None else np.load(path)

        pit = _npy(0, it.pitch).astype(np.float32)
        vec = np.repeat(_npy(1, it.vec), 2, axis=0)   # 320-hop -> 160-hop x2
        ppg = np.repeat(_npy(2, it.ppg), 2, axis=0)
        spk = _npy(3, it.spk).astype(np.float32)

        len_min = min(pit.shape[0], vec.shape[0] - 2, ppg.shape[0] - 2, spec.shape[0])
        pit, vec, ppg, spec = pit[:len_min], vec[:len_min], ppg[:len_min], spec[:len_min]
        audio = audio[: len_min * self.hop]

        use = it.frames
        if len_min > use:
            start = int(rng.integers(0, len_min - use)) if rng is not None else 0
            pit = pit[start : start + use]
            vec = vec[start : start + use]
            ppg = ppg[start : start + use]
            spec = spec[start : start + use]
            audio = audio[start * self.hop : (start + use) * self.hop]
        return dict(ppg=ppg.astype(np.float32), vec=vec.astype(np.float32),
                    pit=pit, spk=spk, spec=spec.astype(np.float32),
                    audio=audio.astype(np.float32))


def boundaries_for(hp_data) -> tuple[int, ...]:
    """The reference's [150, 300, 450] frames for a 25-frame segment, as
    (6, 12, 18) segments of any config's segment length."""
    seg = hp_data.segment_size // hp_data.hop_length
    return tuple(seg * k for k in (6, 12, 18))


class BucketBatcher:
    """Epoch iterator of padded numpy batches.

    Buckets by usable frames (the reference DistributedBucketSampler: items
    outside (b0, b_last] are dropped, epoch-seeded shuffle, pad-repeat to a
    multiple of the global batch, rank::num_replicas subsample), then pads
    every example to its bucket's upper boundary. Every rank draws the same
    numbers in the same order, so the ranks agree on the bucket of each step.
    """

    def __init__(self, dataset: SvcDataset, batch_size: int, boundaries,
                 num_replicas: int = 1, rank: int = 0, seed: int = 1234):
        self.ds = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas, self.rank = num_replicas, rank
        self.seed = seed
        self.buckets = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(dataset.lengths):
            for b in range(len(self.boundaries) - 1):
                if self.boundaries[b] < length <= self.boundaries[b + 1]:
                    self.buckets[b].append(i)
                    break

    def epoch_batches(self, epoch: int):
        rng = np.random.default_rng(self.seed + epoch)
        all_batches = []
        for b, bucket in enumerate(self.buckets):
            if not bucket:
                continue
            pad_to = min(self.boundaries[b + 1], self.ds.max_frames)
            ids = list(rng.permutation(len(bucket)))
            rem = -len(ids) % (self.num_replicas * self.batch_size)
            ids = ids + ids * (rem // len(ids)) + ids[: rem % len(ids)]
            ids = ids[self.rank :: self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                chunk = [bucket[k] for k in ids[j * self.batch_size : (j + 1) * self.batch_size]]
                all_batches.append((chunk, pad_to))
        order = rng.permutation(len(all_batches))
        for k in order:
            chunk, pad_to = all_batches[int(k)]
            yield self._collate(chunk, pad_to, rng)

    def _collate(self, idxs: list[int], pad_frames: int, rng) -> dict:
        hop = self.ds.hop
        b = len(idxs)
        examples = [self.ds.get(i, rng) for i in idxs]
        ppg_dim = examples[0]["ppg"].shape[1]
        vec_dim = examples[0]["vec"].shape[1]
        spec_dim = examples[0]["spec"].shape[1]
        # np.empty, the content, then zeros for the pad tail only: every
        # byte written once on the producer thread
        out = dict(
            ppg=np.empty((b, pad_frames, ppg_dim), np.float32),
            vec=np.empty((b, pad_frames, vec_dim), np.float32),
            pit=np.empty((b, pad_frames), np.float32),
            spk=np.empty((b, examples[0]["spk"].shape[0]), np.float32),
            spec=np.empty((b, pad_frames, spec_dim), np.float32),
            audio=np.empty((b, pad_frames * hop, 1), np.float32),
            ppg_l=np.zeros((b,), np.int32),
            spec_l=np.zeros((b,), np.int32),
        )
        for i, ex in enumerate(examples):
            t = ex["ppg"].shape[0]
            for key in ("ppg", "vec", "pit", "spec"):
                out[key][i, :t] = ex[key]
                out[key][i, t:] = 0.0
            out["spk"][i] = ex["spk"]
            s = min(len(ex["audio"]), pad_frames * hop)
            out["audio"][i, :s, 0] = ex["audio"][:s]
            out["audio"][i, s:] = 0.0
            out["ppg_l"][i] = t
            out["spec_l"][i] = t
        return out

    def batches_per_epoch(self) -> int:
        total = self.num_replicas * self.batch_size
        return sum(-(-len(bucket) // total) * total // self.num_replicas // self.batch_size
                   for bucket in self.buckets)
