"""The preprocessing driver (JAX whisper_vits_svc_tpu/data/preprocess.py;
reference svc_preprocessing.py:14-25 and prepare/*.py): one process runs
idempotent stages over the `data_svc/` cache layout (an output that exists
is skipped and counted, so a rerun resumes where it stopped).

  * stage-major: each extractor stays loaded on the card while the whole
    dataset streams through it;
  * windows batched ACROSS utterances into fixed-size device batches
    (ppg_window_batch / vec_window_batch / embed_windows), a few row-size
    buckets each, and CREPE's frames packed across utterances into
    CREPE_BATCH-frame batches;
  * `inflight_depth` batches stay launched before the oldest is read back
    (`_Inflight`): the batch functions return the device tensor
    (as_numpy=False), and the host buffers are pinned and refilled fresh
    after each flush, so the copies up stay asynchronous and no launched
    batch reads a buffer being written;
  * host IO (wav reads, npy writes) overlapped with device work through a
    producer thread (data/prefetch.py) and a writer pool.

  dataset_raw/<speaker>/*.wav
    -> data_svc/waves-16k/<spk>/*.wav      (peak-0.6 int16, preprocess_a.py)
    -> data_svc/waves-32k/<spk>/*.wav
    -> data_svc/pitch/<spk>/*.pit.npy      (crepe full, hop 160)
    -> data_svc/whisper/<spk>/*.ppg.npy    (24-layer large-v2, [T,1280])
    -> data_svc/hubert/<spk>/*.vec.npy     ([T,256])
    -> data_svc/speaker/<spk>/*.spk.npy    (256-d d-vector per utterance)
    -> data_svc/singer/<spk>.spk.npy       (per-speaker mean)
    -> data_svc/specs/<spk>/*.spec.npy     (linear spec [T,513] @32k hop 320)
  files/train.txt, files/valid.txt         (existence-checked rows)

`serial=True` is the per-utterance loop the staged driver is held to.
CDC and silence trimming (the VCTK clean-up) and the silence split are
host-side float32 / numpy, as in the JAX package.
"""

from __future__ import annotations

import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.stft import istft, linear_spectrogram, stft_complex, stft_magnitude
from ..utils.audio_io import load_wav, resample, save_wav
from ..utils.device import resolve_device
from .prefetch import prefetch

SPEC_BUCKET_SAMPLES = 128000  # 4 s at 32 kHz
SPK_NF_BUCKETS = (32, 64, 125, 250)
SPK_WINDOWS = 10  # d-vector windows per utterance (lstm.py:76-101)
CREPE_BATCH = 512  # frames a CREPE call, torchcrepe's batch (the serial loop's)


def list_raw_wavs(dataset_raw: str) -> dict[str, list[str]]:
    """speaker -> wav paths (prepare/preprocess_a.py directory convention)."""
    out = {}
    for spk in sorted(os.listdir(dataset_raw)):
        d = os.path.join(dataset_raw, spk)
        if os.path.isdir(d):
            wavs = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".wav"))
            if wavs:
                out[spk] = wavs
    return out


@dataclass
class Extractors:
    """The extractor modules on their device; a None skips its stage
    (checkpoints are external artifacts, reference *_pretrain/README.md)."""

    crepe: nn.Module | None = None
    whisper: nn.Module | None = None
    hubert: nn.Module | None = None
    speaker: nn.Module | None = None


def _ensure(path):
    os.makedirs(path, exist_ok=True)
    return path


def _spec_program(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Linear-spectrogram frames of ALREADY vits-prepadded, zero-extended rows
    [B, Lb] (the reflect pad is done on the host, so the bucket's zero
    padding cannot change the reflection: real frames equal
    linear_spectrogram of the natural length)."""
    with torch.inference_mode():
        return stft_magnitude(y, n_fft, hop, win, center=False, mag_eps=1e-6)


def _spec_rows(rows: torch.Tensor, lengths: list[int], n_fft: int, hop: int,
               win: int) -> torch.Tensor:
    """Spectrogram frames of each prepadded row at its own length, stacked
    zero-padded [B, frames, bins]. A product over the whole bucket would sum
    each 1024-tap frame in another order than the utterance's own product
    (the GEMM is chosen by its shape: 2.4e-4 apart at a peak of ~150 on an
    H100), so each row takes linear_spectrogram's product and equals it to
    the bit."""
    with torch.inference_mode():
        specs = [stft_magnitude(rows[i : i + 1, :n], n_fft, hop, win, center=False,
                                mag_eps=1e-6)[0] for i, n in enumerate(lengths)]
        return torch.nn.utils.rnn.pad_sequence(specs, batch_first=True)


def _prepad(a32: np.ndarray, n_fft: int, hop: int) -> tuple[np.ndarray, int]:
    """Reflect pre-pad of the VITS spectrogram -> (padded row, frame count)."""
    pad = int((n_fft - hop) / 2)
    y = np.pad(a32.astype(np.float32), (pad, pad), mode="reflect")
    return y, 1 + (len(y) - n_fft) // hop


def compute_spec_bucketed(a32: np.ndarray, n_fft: int, hop: int, win: int,
                          bucket_samples: int = SPEC_BUCKET_SAMPLES,
                          device: str | torch.device | None = "cuda") -> np.ndarray:
    """[T] 32 kHz audio -> [frames, n_fft//2+1], the row zero-extended to a
    whole 4 s bucket, on `device` (the card by default)."""
    dev = resolve_device(device)
    y, n_frames = _prepad(a32, n_fft, hop)
    lb = -(-len(y) // bucket_samples) * bucket_samples
    y = np.pad(y, (0, lb - len(y)))
    spec = _spec_program(torch.from_numpy(y)[None].to(dev), n_fft, hop, win)
    return spec[0, :n_frames].float().cpu().numpy()


def _cut_windows(audio: np.ndarray, window_samples: int):
    """[(row [window_samples] zero-padded, real_len)]: the reference's window
    walk (whisper/inference.py:36-52, hubert/inference.py:29-48: a window
    starts at every multiple of the window size below len)."""
    out = []
    for s in range(0, len(audio), window_samples):
        seg = audio[s : s + window_samples]
        row = np.zeros(window_samples, np.float32)
        row[: len(seg)] = seg
        out.append((row, len(seg)))
    return out


def _window_buckets(window_samples: int) -> list[int]:
    """Row-size buckets {w/8, w/4, w/2, w} (rounded up to the 320-hop grid):
    a short utterance or tail runs in the smallest batch shape that fits
    instead of padding to the full window; the extractors are length-masked,
    so the result is the same with 2-8x fewer operations."""
    out = []
    for div in (8, 4, 2, 1):
        b = -(-window_samples // div // 320) * 320
        if not out or b > out[-1]:
            out.append(b)
    return out


class _Inflight:
    """Bounded queue of launched but unread device batches.

    CUDA launches are asynchronous: `push` queues a batch's device tensor and
    reads back (.cpu(), which waits) only the OLDEST entry once more than
    `depth` are queued, so the card computes batch N while the host packs and
    harvests around it."""

    def __init__(self, depth: int = 2):
        self.q = deque()
        self.depth = max(1, depth)

    def push(self, device_out: torch.Tensor, harvest):
        """harvest(np_out) is called when this batch is read back."""
        self.q.append((device_out, harvest))
        while len(self.q) > self.depth:
            self._pop()

    def _pop(self):
        device_out, harvest = self.q.popleft()
        harvest(device_out.float().cpu().numpy())

    def drain(self):
        while self.q:
            self._pop()


def _run_window_stage(pending, window_samples, batch_windows, run_batch, frames_of_len,
                      feat_dim, log, label, inflight_depth: int = 2, pin: bool = False):
    """Stream utterances through a few fixed-shape device batches (one per
    size bucket).

    pending: [(a16_path, out_path)]. A producer thread loads audio and cuts
    windows; rows are packed ACROSS utterance boundaries into
    [batch_windows, bucket] batches (bucket = the smallest of
    _window_buckets that fits the row); per-row outputs are cut to
    frames_of_len(real_len) and put together per utterance.
    run_batch(rows, lens) gets CPU tensors (pinned when `pin`) and must
    return the device tensor without reading it back."""
    if not pending:
        return

    buckets = _window_buckets(window_samples)

    def rows():
        for a16_path, out_path in pending:
            audio, _ = load_wav(a16_path)
            cuts = _cut_windows(audio, window_samples)
            utt = {"path": out_path, "n": len(cuts), "parts": [None] * len(cuts), "done": 0}
            if not cuts:
                yield (utt, None, None, None)
                continue
            for wi, (row, ln) in enumerate(cuts):
                yield (utt, wi, row, ln)

    writer = ThreadPoolExecutor(max_workers=2)
    done_utts = 0

    def finish(utt):
        nonlocal done_utts
        feats = (np.concatenate(utt["parts"], axis=0) if utt["parts"]
                 else np.zeros((0, feat_dim), np.float32))
        writer.submit(np.save, utt["path"], feats, allow_pickle=False)
        done_utts += 1

    def fresh(b):
        return (torch.zeros((batch_windows, b), pin_memory=pin),
                torch.full((batch_windows,), b, dtype=torch.int64, pin_memory=pin))

    buf, lens = {}, {}
    for b in buckets:
        buf[b], lens[b] = fresh(b)
    slots: dict[int, list[tuple[dict, int]]] = {b: [] for b in buckets}
    inflight = _Inflight(inflight_depth)

    def flush(b):
        sl = slots[b]
        if not sl:
            return
        out_dev = run_batch(buf[b], lens[b])
        records, lens_snap = list(sl), lens[b].numpy().copy()

        def harvest(out, records=records, lens_snap=lens_snap):
            for i, (utt, wi) in enumerate(records):
                utt["parts"][wi] = out[i, : frames_of_len(int(lens_snap[i])), :]
                utt["done"] += 1
                if utt["done"] == utt["n"]:
                    finish(utt)

        inflight.push(out_dev, harvest)
        sl.clear()
        # fresh buffers, not zeroed in place: the launched batch's copies up
        # may still read the old ones
        buf[b], lens[b] = fresh(b)

    for utt, wi, row, ln in prefetch(rows(), depth=2 * batch_windows):
        if wi is None:  # zero-length audio
            finish(utt)
            continue
        b = next(bk for bk in buckets if ln <= bk)
        i = len(slots[b])
        buf[b].numpy()[i, :ln] = row[:ln]
        lens[b][i] = ln
        slots[b].append((utt, wi))
        if len(slots[b]) == batch_windows:
            flush(b)
    for b in buckets:
        flush(b)
    inflight.drain()
    writer.shutdown(wait=True)
    log(f"{label}: {done_utts} utterances")


def _run_crepe_stage(pending, model, seed, log, batch_frames: int = CREPE_BATCH,
                     inflight_depth: int = 2):
    """CREPE F0 of every pending (a16_path, pit_path), compute_f0's values.

    Each utterance draws its noise and its dither from its own
    default_rng(seed), as the serial loop does. Its frames are packed ACROSS
    utterance boundaries into [batch_frames, 1024] batches (only the
    stage's last batch is zero-padded: the JAX package pads every utterance
    to 2048-frame batches), `inflight_depth` batches launched before the
    oldest is read back; an utterance is decoded (Viterbi, dither, filters)
    once its last frame is back. Frames are independent, so the packing
    does not change a value."""
    from ..models.crepe import f0_from_probabilities, normalize_frames, train_frames

    if not pending:
        return
    dev = _device_of(model)
    pin = dev.type == "cuda"
    waiting = deque()  # (pit_path, rng, frames) in frame order
    rows, n_rows = [], 0  # probabilities read back and not yet claimed
    writer = ThreadPoolExecutor(max_workers=2)
    done = 0

    def claim():
        nonlocal rows, n_rows, done
        while waiting and waiting[0][2] <= n_rows:
            pit_path, rng, n = waiting.popleft()
            probs = np.concatenate(rows) if rows else np.zeros((0, 360), np.float32)
            rows, n_rows = [probs[n:]], n_rows - n
            writer.submit(np.save, pit_path, f0_from_probabilities(probs[:n], rng, dev),
                          allow_pickle=False)
            done += 1

    def harvest(probs, n):
        nonlocal n_rows
        rows.append(probs[:n])
        n_rows += n
        claim()

    def fresh():
        return torch.zeros((batch_frames, 1024), pin_memory=pin)

    buf, filled = fresh(), 0
    inflight = _Inflight(inflight_depth)

    def flush():
        nonlocal buf, filled
        if filled:
            with torch.inference_mode():
                out = model(normalize_frames(buf.to(dev, non_blocking=True)))
            inflight.push(out, lambda probs, n=filled: harvest(probs, n))
            # a fresh buffer: the launched batch's copy up may still read this one
            buf, filled = fresh(), 0

    def _load(pair):
        return pair[1], load_wav(pair[0])[0]

    for pit_path, a16 in prefetch(map(_load, pending), depth=4):
        rng = np.random.default_rng(seed)
        frames = train_frames(a16, rng)
        waiting.append((pit_path, rng, len(frames)))
        i = 0
        while i < len(frames):
            k = min(batch_frames - filled, len(frames) - i)
            buf.numpy()[filled : filled + k] = frames[i : i + k]
            filled, i = filled + k, i + k
            if filled == batch_frames:
                flush()
    flush()
    inflight.drain()
    claim()
    writer.shutdown(wait=True)
    log(f"pitch: {done} utterances")


def preprocess(
    dataset_raw: str,
    out_dir: str = "data_svc",
    files_dir: str = "files",
    hp_data=None,
    extractors: Extractors | None = None,
    valid_count: int = 10,
    seed: int = 1234,
    progress: bool = True,
    batch_windows: int = 8,
    io_threads: int = 4,
    serial: bool = False,
    hubert_window_seconds: int = 20,
    device: str | torch.device | None = "cuda",
) -> dict:
    """The stage-major batched driver (default) or the per-utterance serial
    loop (serial=True, the A/B baseline). `device` runs the spectrogram
    stage (the card by default); each extractor runs where its module is.
    Returns {"items", "skipped": {stage: cache hits}, "rows"}."""
    dev = resolve_device(device)
    extractors = extractors or Extractors()
    speakers = list_raw_wavs(dataset_raw)
    stats = {"items": 0, "skipped": {}}
    sr32 = 32000 if hp_data is None else hp_data.sampling_rate
    n_fft = 1024 if hp_data is None else hp_data.filter_length
    hop = 320 if hp_data is None else hp_data.hop_length
    win = 1024 if hp_data is None else hp_data.win_length

    def log(msg):
        if progress:
            print(msg)

    for spk, wavs in speakers.items():
        for sub in ["waves-16k", "waves-32k", "pitch", "whisper", "hubert", "speaker", "specs"]:
            _ensure(os.path.join(out_dir, sub, spk))
        _ensure(os.path.join(out_dir, "singer"))
        stats["items"] += len(wavs)

    if serial:
        _preprocess_serial(speakers, out_dir, extractors, sr32, n_fft, hop, win, seed, log,
                           hubert_window_seconds, skipped=stats["skipped"], device=dev)
    else:
        _preprocess_staged(speakers, out_dir, extractors, sr32, n_fft, hop, win, seed, log,
                           batch_windows, io_threads, hubert_window_seconds,
                           skipped=stats["skipped"], device=dev)

    # per-speaker average embedding (prepare/preprocess_speaker_ave.py)
    for spk, wavs in speakers.items():
        singer_path = os.path.join(out_dir, "singer", spk + ".spk.npy")
        spk_dir = os.path.join(out_dir, "speaker", spk)
        embeds = [np.load(os.path.join(spk_dir, f))
                  for f in sorted(os.listdir(spk_dir)) if f.endswith(".spk.npy")]
        if embeds and not os.path.isfile(singer_path):
            np.save(singer_path, np.mean(embeds, axis=0), allow_pickle=False)
        log(f"speaker {spk}: {len(wavs)} items done")

    rows = build_filelists(out_dir, files_dir, valid_count, seed)
    stats["rows"] = len(rows)
    return stats


def _stage_paths(speakers, out_dir):
    """[(spk, name, wav_path, p16, p32)] for every raw item."""
    out = []
    for spk, wavs in speakers.items():
        for wav_path in wavs:
            name = os.path.splitext(os.path.basename(wav_path))[0]
            out.append((spk, name, wav_path,
                        os.path.join(out_dir, "waves-16k", spk, name + ".wav"),
                        os.path.join(out_dir, "waves-32k", spk, name + ".wav")))
    return out


def _resample_item(wav_path, p16, p32, sr32):
    audio, src_sr = load_wav(wav_path)
    save_wav(p16, resample(audio, src_sr, 16000), 16000, peak_norm=0.6)
    save_wav(p32, resample(audio, src_sr, sr32), sr32, peak_norm=0.6)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _preprocess_staged(speakers, out_dir, extractors, sr32, n_fft, hop, win, seed, log,
                       batch_windows, io_threads, hubert_window_seconds=20, skipped=None,
                       device: torch.device = torch.device("cpu")):
    items = _stage_paths(speakers, out_dir)
    skipped = skipped if skipped is not None else {}

    # ---- stage 1: resample, thread-pooled host work (preprocess_a.py:23-30)
    def _resample_one(item):
        _spk, _name, wav_path, p16, p32 = item
        if os.path.isfile(p16) and os.path.isfile(p32):
            return 1
        _resample_item(wav_path, p16, p32, sr32)
        return 0

    with ThreadPoolExecutor(max_workers=io_threads) as pool:
        skipped["resample"] = sum(pool.map(_resample_one, items))
    log(f"resample: {len(items)} items")

    def _pending(sub, suffix):
        pend = [(p16, os.path.join(out_dir, sub, spk, name + suffix))
                for spk, name, _w, p16, _p32 in items
                if not os.path.isfile(os.path.join(out_dir, sub, spk, name + suffix))]
        skipped[sub] = len(items) - len(pend)
        return pend

    # ---- stage 2: crepe F0, frames packed across utterances
    if extractors.crepe is not None:
        _run_crepe_stage(_pending("pitch", ".pit.npy"), extractors.crepe, seed, log)

    # ---- stage 3: whisper PPG, windows batched across utterances
    if extractors.whisper is not None:
        from ..models.whisper import PPG_HOP, WINDOW_SAMPLES, ppg_window_batch

        m = extractors.whisper
        _run_window_stage(
            _pending("whisper", ".ppg.npy"), WINDOW_SAMPLES, batch_windows,
            lambda rows, lens: ppg_window_batch(m, rows, lens, rng=None, as_numpy=False),
            lambda ln: ln // PPG_HOP, m.n_state, log, "whisper ppg",
            pin=_device_of(m).type == "cuda")

    # ---- stage 4: hubert soft units, windows batched across utterances
    if extractors.hubert is not None:
        from ..models.hubert import hubert_num_frames, vec_window_batch

        m = extractors.hubert
        _run_window_stage(
            _pending("hubert", ".vec.npy"), hubert_window_seconds * 16000, batch_windows,
            lambda rows, lens: vec_window_batch(m, rows, lens, as_numpy=False),
            hubert_num_frames, 256, log, "hubert vec", pin=_device_of(m).type == "cuda")

    # ---- stage 5: speaker d-vectors: host-numpy mel frontend, the embed
    # windows batched ACROSS utterances. A window's nf frames are padded up
    # to a small bucket set (exact: causal LSTM, the state of each row's last
    # real frame) and partial groups pad to batch_windows utterances.
    if extractors.speaker is not None:
        from ..models.speaker_encoder import embed_windows, speaker_melspectrogram, trim_silence

        m = extractors.speaker
        pin = _device_of(m).type == "cuda"
        pend = _pending("speaker", ".spk.npy")

        def _mel_windows(pair):
            a16 = load_wav(pair[0])[0]
            mel = speaker_melspectrogram(trim_silence(a16))
            nf = min(250, max(mel.shape[0], 1))
            if mel.shape[0] == 0:
                mel = np.zeros((1, mel.shape[1]), np.float32)
            offsets = np.linspace(0, mel.shape[0] - nf, num=SPK_WINDOWS).astype(int)
            return pair[1], np.stack([mel[o : o + nf] for o in offsets]), nf

        groups: dict[int, list] = {}
        writer = ThreadPoolExecutor(max_workers=2)
        spk_inflight = _Inflight(2)
        n = 0

        def _flush_spk(b):
            grp = groups.pop(b, [])
            if not grp:
                return
            rows_t = torch.zeros((batch_windows * SPK_WINDOWS, b, 80), pin_memory=pin)
            lens_t = torch.full((batch_windows * SPK_WINDOWS,), b, dtype=torch.int64,
                                pin_memory=pin)
            rows, lens_row = rows_t.numpy(), lens_t.numpy()
            for i, (_pth, wins, nf) in enumerate(grp):
                rows[i * SPK_WINDOWS : (i + 1) * SPK_WINDOWS, :nf] = wins
                lens_row[i * SPK_WINDOWS : (i + 1) * SPK_WINDOWS] = nf
            embs_dev = embed_windows(m, rows_t, batch_windows, lens_t, as_numpy=False)

            def harvest(embs, grp=grp):
                for (path, _w, _nf), e in zip(grp, embs):
                    writer.submit(np.save, path, e, allow_pickle=False)

            spk_inflight.push(embs_dev, harvest)

        for spk_path, wins, nf in prefetch(map(_mel_windows, pend), depth=8):
            b = next(bk for bk in SPK_NF_BUCKETS if nf <= bk)
            groups.setdefault(b, []).append((spk_path, wins, nf))
            n += 1
            if len(groups[b]) == batch_windows:
                _flush_spk(b)
        for b in list(groups):
            _flush_spk(b)
        spk_inflight.drain()
        writer.shutdown(wait=True)
        log(f"speaker embed: {n} utterances")

    # ---- stage 6: linear specs: host reflect pad, rows uploaded in batches
    # across utterances per length bucket; each row's frames are taken at
    # its own length (_spec_rows)
    pend_spec = [(p32, os.path.join(out_dir, "specs", spk, name + ".spec.npy"))
                 for spk, name, _w, _p16, p32 in items
                 if not os.path.isfile(os.path.join(out_dir, "specs", spk, name + ".spec.npy"))]
    skipped["specs"] = len(items) - len(pend_spec)
    pin = device.type == "cuda"

    def _prepad_32(pair):
        return (pair[1], *_prepad(load_wav(pair[0])[0], n_fft, hop))

    sgroups: dict[int, list] = {}
    swriter = ThreadPoolExecutor(max_workers=2)
    spec_inflight = _Inflight(2)
    n = 0

    def _flush_spec(lb):
        grp = sgroups.pop(lb, [])
        if not grp:
            return
        rows_t = torch.zeros((len(grp), lb), pin_memory=pin)
        rows = rows_t.numpy()
        for i, (_pth, y, _nf) in enumerate(grp):
            rows[i, : len(y)] = y
        spec_dev = _spec_rows(rows_t.to(device, non_blocking=True),
                              [len(y) for _, y, _ in grp], n_fft, hop, win)

        def harvest(spec, grp=grp):
            for i, (pth, _y, nfr) in enumerate(grp):
                swriter.submit(np.save, pth, spec[i, :nfr].astype(np.float32),
                               allow_pickle=False)

        spec_inflight.push(spec_dev, harvest)

    for spec_path, y, nfr in prefetch(map(_prepad_32, pend_spec), depth=8):
        lb = -(-len(y) // SPEC_BUCKET_SAMPLES) * SPEC_BUCKET_SAMPLES
        sgroups.setdefault(lb, []).append((spec_path, y, nfr))
        n += 1
        if len(sgroups[lb]) == batch_windows:
            _flush_spec(lb)
    for lb in list(sgroups):
        _flush_spec(lb)
    spec_inflight.drain()
    swriter.shutdown(wait=True)
    log(f"specs: {n} utterances")


def _preprocess_serial(speakers, out_dir, extractors, sr32, n_fft, hop, win, seed, log,
                       hubert_window_seconds=20, skipped=None,
                       device: torch.device = torch.device("cpu")):
    """Every stage for one wav before the next wav: the A/B baseline the
    staged driver is measured and checked against."""
    skipped = skipped if skipped is not None else {}

    def _skip(stage):
        skipped[stage] = skipped.get(stage, 0) + 1

    def _sub(sub, spk, name, suffix):
        return os.path.join(out_dir, sub, spk, name + suffix)

    for spk, wavs in speakers.items():
        for wav_path in wavs:
            name = os.path.splitext(os.path.basename(wav_path))[0]
            p16 = os.path.join(out_dir, "waves-16k", spk, name + ".wav")
            p32 = os.path.join(out_dir, "waves-32k", spk, name + ".wav")
            if not os.path.isfile(p16) or not os.path.isfile(p32):
                _resample_item(wav_path, p16, p32, sr32)
            else:
                _skip("resample")
            a16, _ = load_wav(p16)
            a32, _ = load_wav(p32)

            pit_path = _sub("pitch", spk, name, ".pit.npy")
            if extractors.crepe is not None and os.path.isfile(pit_path):
                _skip("pitch")
            elif extractors.crepe is not None:
                from ..models.crepe import compute_f0

                np.save(pit_path, compute_f0(extractors.crepe, a16, np.random.default_rng(seed)),
                        allow_pickle=False)

            ppg_path = _sub("whisper", spk, name, ".ppg.npy")
            if extractors.whisper is not None and os.path.isfile(ppg_path):
                _skip("whisper")
            elif extractors.whisper is not None:
                from ..models.whisper import pred_ppg

                np.save(ppg_path, pred_ppg(extractors.whisper, a16, rng=None),
                        allow_pickle=False)

            vec_path = _sub("hubert", spk, name, ".vec.npy")
            if extractors.hubert is not None and os.path.isfile(vec_path):
                _skip("hubert")
            elif extractors.hubert is not None:
                from ..models.hubert import pred_vec

                np.save(vec_path, pred_vec(extractors.hubert, a16,
                                           window_seconds=hubert_window_seconds),
                        allow_pickle=False)

            spk_path = _sub("speaker", spk, name, ".spk.npy")
            if extractors.speaker is not None and os.path.isfile(spk_path):
                _skip("speaker")
            elif extractors.speaker is not None:
                from ..models.speaker_encoder import compute_embedding

                np.save(spk_path, compute_embedding(extractors.speaker, a16),
                        allow_pickle=False)

            spec_path = _sub("specs", spk, name, ".spec.npy")
            if os.path.isfile(spec_path):
                _skip("specs")
            else:
                with torch.inference_mode():
                    spec = linear_spectrogram(torch.from_numpy(a32)[None].to(device),
                                              n_fft, hop, win)
                np.save(spec_path, spec[0].float().cpu().numpy(), allow_pickle=False)


def cut_direct_content(audio: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Zero the DC and first STFT bins, resynthesize (CDC VCTK clean-up,
    reference prepare/preprocess_cdc.py:17-28), in float32 on the host.

    float [-1, 1] in -> float out; the int16 quantization with torch-style
    truncation toward zero (`.short()`) happens in `cdc_directory`."""
    y = torch.from_numpy(np.asarray(audio, np.float32))[None]
    re, im = stft_complex(y, n_fft, hop, n_fft, window="hann", center=True,
                          pad_mode="reflect")
    mask = torch.ones(n_fft // 2 + 1)
    mask[:2] = 0.0
    out = istft(re * mask, im * mask, n_fft, hop, n_fft, center=True, length=len(audio))
    return out[0].numpy()


def _quantize_int16_trunc(audio: np.ndarray) -> np.ndarray:
    """32768 x clamped to [-32768, 32767], then truncated toward zero: the
    `(MAX_WAV_VALUE * x).clamp(...).short()` of preprocess_cdc.py:23-25."""
    x = np.clip(audio * 32768.0, -32768.0, 32767.0)
    return np.trunc(x).astype(np.int16)


def detect_silence_ms(audio: np.ndarray, sr: int, min_silence_len: int = 200,
                      silence_thresh: float = -45.0) -> list[list[int]]:
    """Silent [start_ms, end_ms) ranges, pydub.silence.detect_silence
    semantics (1 ms seek step; a window is silent when its RMS dBFS, relative
    to int16 full scale, is below the threshold)."""
    n_ms = int(len(audio) // (sr // 1000))
    if n_ms < min_silence_len:
        return []
    spms = sr // 1000
    # per-ms energy prefix sum -> O(1) windowed RMS
    e = (audio[: n_ms * spms].astype(np.float64) ** 2).reshape(n_ms, spms).sum(1)
    cum = np.concatenate([[0.0], np.cumsum(e)])
    win_e = cum[min_silence_len:] - cum[:-min_silence_len]  # per start ms
    rms = np.sqrt(win_e / (min_silence_len * spms))
    silent = rms < 10.0 ** (silence_thresh / 20.0)

    ranges: list[list[int]] = []
    start = None
    for i, s in enumerate(silent):
        if s and start is None:
            start = i
        elif not s and start is not None:
            ranges.append([start, i - 1 + min_silence_len])
            start = None
    if start is not None:
        ranges.append([start, len(silent) - 1 + min_silence_len])
    return ranges


def split_on_silence(audio: np.ndarray, sr: int, min_silence_len: int = 200,
                     silence_thresh: float = -45.0, keep_silence: int = 200) -> list[np.ndarray]:
    """Non-silent chunks each padded with keep_silence ms, pydub
    split_on_silence semantics (overlapping pads split at the midpoint)."""
    n_ms = int(len(audio) // (sr // 1000))
    silence = detect_silence_ms(audio, sr, min_silence_len, silence_thresh)
    nonsilent, prev = [], 0
    for s, e in silence:
        if s > prev:
            nonsilent.append([prev, s])
        prev = e
    if prev < n_ms:
        nonsilent.append([prev, n_ms])
    if not nonsilent:
        return []
    out_ranges = [[max(0, s - keep_silence), min(n_ms, e + keep_silence)] for s, e in nonsilent]
    for a, b in zip(out_ranges, out_ranges[1:]):
        if a[1] > b[0]:
            a[1] = b[0] = (a[1] + b[0]) // 2
    spms = sr // 1000
    return [audio[s * spms : e * spms] for s, e in out_ranges]


def trim_silence_concat(audio: np.ndarray, sr: int, min_silence_len: int = 200,
                        silence_thresh: float = -45.0, keep_silence: int = 200) -> np.ndarray:
    """Drop long internal silences and concatenate the speech chunks
    (reference prepare/preprocess_trim.py:12-25: pydub split_on_silence, then
    chunks[0] += chunk). Returns the input untouched when nothing is split."""
    chunks = split_on_silence(audio, sr, min_silence_len, silence_thresh, keep_silence)
    if not chunks:
        return audio
    return np.concatenate(chunks)


def _per_speaker_wavs(in_path: str, out_path: str):
    for spk in sorted(os.listdir(in_path)):
        d = os.path.join(in_path, spk)
        if not os.path.isdir(d):
            continue
        _ensure(os.path.join(out_path, spk))
        for f in sorted(os.listdir(d)):
            if f.endswith(".wav"):
                yield spk, os.path.join(d, f), os.path.join(out_path, spk, f)


def cdc_directory(in_path: str, out_path: str, progress: bool = True) -> int:
    """CDC over a speaker-per-subdir tree (prepare/preprocess_cdc.py CLI)."""
    from scipy.io import wavfile

    n = 0
    for spk, src, dst in _per_speaker_wavs(in_path, out_path):
        audio, sr = load_wav(src)
        wavfile.write(dst, sr, _quantize_int16_trunc(cut_direct_content(audio)))
        n += 1
        if progress:
            print(f"cdc {spk}/{os.path.basename(src)}")
    return n


def trim_directory(in_path: str, out_path: str, progress: bool = True) -> int:
    """Silence trim over a speaker-per-subdir tree (prepare/preprocess_trim.py
    CLI; run after CDC for VCTK)."""
    from scipy.io import wavfile

    n = 0
    for spk, src, dst in _per_speaker_wavs(in_path, out_path):
        audio, sr = load_wav(src)
        wavfile.write(dst, sr, _quantize_int16_trunc(trim_silence_concat(audio, sr)))
        n += 1
        if progress:
            print(f"trim {spk}/{os.path.basename(src)}")
    return n


def dataset_dry_run(hp, files_dir: str = "files", batch_size: int = 2) -> int:
    """Load every item and one bucketed epoch, so that shape and file errors
    surface before training (reference prepare/preprocess_zzz.py:11-31, stage
    10 of svc_preprocessing). `hp` is the config's data section. Returns the
    number of batches."""
    from .dataset import BucketBatcher, SvcDataset, boundaries_for

    ds = SvcDataset(os.path.join(files_dir, "train.txt"), hp)
    rng = np.random.default_rng(0)
    for i in range(len(ds)):
        ex = ds.get(i, rng)
        t = ex["ppg"].shape[0]
        assert ex["vec"].shape[0] == t and ex["spec"].shape[0] == t, i
        assert len(ex["audio"]) == t * hp.hop_length, i
    batcher = BucketBatcher(ds, batch_size, boundaries=boundaries_for(hp))
    n = 0
    for batch in batcher.epoch_batches(0):
        assert np.isfinite(batch["ppg"]).all()
        n += 1
    print(f"dataset dry-run ok: {len(ds)} items, {n} batches")
    return n


def build_filelists(out_dir: str, files_dir: str, valid_count: int = 10,
                    seed: int = 1234) -> list[str]:
    """Existence-checked train/valid rows (prepare/preprocess_train.py:33-68):
    "wave|spec|pitch|hubert|whisper|spk"."""
    rows = []
    wav_root = os.path.join(out_dir, "waves-32k")
    if not os.path.isdir(wav_root):
        return rows
    for spk in sorted(os.listdir(wav_root)):
        for f in sorted(os.listdir(os.path.join(wav_root, spk))):
            if not f.endswith(".wav"):
                continue
            name = f[:-4]
            paths = [
                os.path.join(out_dir, "waves-32k", spk, f),
                os.path.join(out_dir, "specs", spk, name + ".spec.npy"),
                os.path.join(out_dir, "pitch", spk, name + ".pit.npy"),
                os.path.join(out_dir, "hubert", spk, name + ".vec.npy"),
                os.path.join(out_dir, "whisper", spk, name + ".ppg.npy"),
                os.path.join(out_dir, "speaker", spk, name + ".spk.npy"),
            ]
            missing = [p for p in paths if not os.path.isfile(p)]
            if missing:
                print(f"\033[31mmissing {missing[0]} — skipping {name}\033[0m")
                continue
            rows.append("|".join(paths))
    random.Random(seed).shuffle(rows)
    os.makedirs(files_dir, exist_ok=True)
    # hold out at most half the data so tiny datasets keep a disjoint train set
    # (the reference assumes >10 items and would leave train empty below that)
    valid_count = min(valid_count, len(rows) // 2)
    valid = rows[:valid_count]
    train = rows[valid_count:]
    with open(os.path.join(files_dir, "valid.txt"), "w") as f:
        f.write("\n".join(valid) + ("\n" if valid else ""))
    with open(os.path.join(files_dir, "train.txt"), "w") as f:
        f.write("\n".join(train) + ("\n" if train else ""))
    return rows
