"""Learnable synthetic dataset for training-health runs (JAX
tools/make_synth_dataset.py).

Random feature caches carry no information about the audio, so a model
trained on them can only memorise and its validation mel stays flat. Here
the mapping is learnable: ppg/vec are fixed linear projections of the true
synthesis parameters (phoneme state, log-F0, envelope), the pitch cache is
the true F0 contour, and the audio is additive-harmonic synthesis from
exactly those parameters. Held-out utterances come from the same process,
so a model that learns the mapping generalises and validation mel falls.

Writes dataset_raw/ wavs + data_svc/ caches (base dims: ppg 1280, vec 256,
spk 256) + files/ lists, in the standard layout. Equal seeds give the JAX
tool's files: the same draws in the same order, the wavs and caches equal,
the specs within float32 rounding (they are computed on `--device`).

    python -m whisper_vits_svc_tpu_torch.tools.make_synth_dataset --out WS
        [--n-utts 60] [--n-speakers 6] [--seed 0] [--min-secs 2.2]
        [--max-secs 3.9] [--device cuda|cpu]

Runs the spectrograms on the card; without CUDA it refuses to start unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.preprocess import build_filelists, compute_spec_bucketed
from ..utils.audio_io import resample, save_wav
from ..utils.device import resolve_device

SR = 32000
HOP = 320


def synth_utterance(rng, secs: float, proj_ppg, proj_vec, n_state: int = 8):
    """-> (audio [S], f0_frames [T], ppg [(T+1)//2, 1280], vec [(T+1)//2, 256])."""
    n = int(secs * SR)
    t_frames = n // HOP
    n = t_frames * HOP

    # slow random-walk phoneme state, frame rate
    state = np.zeros((t_frames, n_state), np.float32)
    x = rng.standard_normal(n_state) * 0.5
    for i in range(t_frames):
        x = 0.98 * x + 0.2 * rng.standard_normal(n_state)
        state[i] = x

    # f0: random-walk in log space + vibrato
    base = rng.uniform(np.log(140), np.log(320))
    walk = np.cumsum(rng.standard_normal(t_frames) * 0.004)
    f0_frames = np.exp(base + walk).astype(np.float32)
    f0_frames *= (1 + 0.01 * np.sin(2 * np.pi * 5.5 * np.arange(t_frames) * HOP / SR)
                  ).astype(np.float32)

    env_frames = (0.55 + 0.4 * np.sin(
        2 * np.pi * rng.uniform(0.3, 1.0) * np.arange(t_frames) * HOP / SR
        + rng.uniform(0, 6.28))).astype(np.float32)

    # audio: harmonics whose amplitudes follow the phoneme state
    f0_s = np.repeat(f0_frames, HOP)
    env_s = np.repeat(env_frames, HOP)
    phase = 2 * np.pi * np.cumsum(f0_s) / SR
    amps = 0.5 * np.abs(np.tanh(state[:, :5])) + 0.05  # [T, 5]
    audio = np.zeros(n, np.float32)
    for h in range(1, 6):
        audio += np.repeat(amps[:, h - 1], HOP) / h * np.sin(h * phase).astype(np.float32)
    audio = (audio * env_s * 0.5
             + 0.005 * rng.standard_normal(n)).astype(np.float32)
    peak = np.abs(audio).max()
    audio = audio / max(peak, 1e-6) * 0.6

    # features at the 320-hop PPG rate ((T+1)//2 rows; the dataset repeats x2)
    feats = np.concatenate(
        [state, np.log(f0_frames)[:, None] - 5.0, env_frames[:, None]], axis=1
    )[::2].astype(np.float32)  # [(T+1)//2, n_state+2]
    ppg = feats @ proj_ppg + rng.standard_normal((len(feats), 1280)) * 0.01
    vec = feats @ proj_vec + rng.standard_normal((len(feats), 256)) * 0.01
    return audio, f0_frames, ppg.astype(np.float32), vec.astype(np.float32)


def main(argv=None) -> list[str]:
    """Writes the workspace; returns the filelist rows (train and valid)."""
    ap = argparse.ArgumentParser(prog="make_synth_dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-utts", type=int, default=60)
    ap.add_argument("--n-speakers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-secs", type=float, default=2.2)
    ap.add_argument("--max-secs", type=float, default=3.9)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the spectrograms are computed")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    proj_ppg = (rng.standard_normal((10, 1280)) * 0.3).astype(np.float32)
    proj_vec = (rng.standard_normal((10, 256)) * 0.3).astype(np.float32)
    spk_emb = rng.standard_normal((args.n_speakers, 256)).astype(np.float32)
    spk_emb /= np.linalg.norm(spk_emb, axis=1, keepdims=True)

    ws = args.out
    for i in range(args.n_utts):
        s = i % args.n_speakers
        spk = f"spk_{s}"
        for sub in ["waves-16k", "waves-32k", "pitch", "whisper", "hubert",
                    "speaker", "specs"]:
            os.makedirs(os.path.join(ws, "data_svc", sub, spk), exist_ok=True)
        os.makedirs(os.path.join(ws, "data_svc", "singer"), exist_ok=True)
        os.makedirs(os.path.join(ws, "dataset_raw", spk), exist_ok=True)

        secs = float(rng.uniform(args.min_secs, args.max_secs))
        audio, f0, ppg, vec = synth_utterance(rng, secs, proj_ppg, proj_vec)
        name = f"u{i:03d}"
        save_wav(os.path.join(ws, "dataset_raw", spk, name + ".wav"), audio, SR)
        save_wav(os.path.join(ws, "data_svc", "waves-32k", spk, name + ".wav"),
                 audio, SR, peak_norm=0.6)
        save_wav(os.path.join(ws, "data_svc", "waves-16k", spk, name + ".wav"),
                 resample(audio, SR, 16000), 16000, peak_norm=0.6)
        np.save(os.path.join(ws, "data_svc", "pitch", spk, name + ".pit.npy"),
                f0, allow_pickle=False)
        np.save(os.path.join(ws, "data_svc", "whisper", spk, name + ".ppg.npy"),
                ppg, allow_pickle=False)
        np.save(os.path.join(ws, "data_svc", "hubert", spk, name + ".vec.npy"),
                vec, allow_pickle=False)
        emb = spk_emb[s] + rng.standard_normal(256).astype(np.float32) * 0.01
        np.save(os.path.join(ws, "data_svc", "speaker", spk, name + ".spk.npy"),
                emb / np.linalg.norm(emb), allow_pickle=False)
        # real linear spec from the peak-normed 32k wav (the training input)
        a32 = np.clip(audio / max(np.abs(audio).max(), 1e-6) * 0.6, -1, 1)
        pcm = np.trunc(np.clip(a32 * 32768.0, -32768, 32767)) / 32768.0
        np.save(os.path.join(ws, "data_svc", "specs", spk, name + ".spec.npy"),
                compute_spec_bucketed(pcm.astype(np.float32), 1024, HOP, 1024,
                                      device=device),
                allow_pickle=False)

    for s in range(args.n_speakers):
        spk = f"spk_{s}"
        d = os.path.join(ws, "data_svc", "speaker", spk)
        embs = [np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))]
        np.save(os.path.join(ws, "data_svc", "singer", spk + ".spk.npy"),
                np.mean(embs, axis=0), allow_pickle=False)

    # relative paths in the filelists, as the JAX tool writes them
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        rows = build_filelists("data_svc", "files", valid_count=10, seed=1234)
    finally:
        os.chdir(cwd)
    print(f"{args.n_utts} utterances ({args.n_speakers} speakers), "
          f"{len(rows)} filelist rows -> {ws}")
    return rows


if __name__ == "__main__":
    main()
