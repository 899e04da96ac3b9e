"""svc_inference CLI for precomputed features (reference svc_inference.py).

    python -m whisper_vits_svc_tpu_torch.cli.inference --config configs/base.yaml \
        --model model.ckpt --spk spk.npy --ppg x.ppg.npy --vec x.vec.npy \
        --pit x.pit.csv [--shift 2] [--out svc_out.wav] [--device cuda]

Writes `--out` and svc_out_pit.wav (the excitation) as 16-bit WAVs. The
feature extractors (whisper, hubert, crepe) are not ported yet, so --ppg,
--vec and --pit are required.
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.io import wavfile

from ..infer import pipeline
from ..infer.retrieval import DummyRetrieval
from ..utils.config import load_config

MAX_WAV_VALUE = 32768.0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="svc_inference")
    p.add_argument("--config", required=True, help="yaml config")
    p.add_argument("--model", required=True, help="JAX .ckpt or reference .pth")
    p.add_argument("--spk", required=True, help="speaker embedding npy")
    p.add_argument("--ppg", default=None, help="whisper ppg npy (20 ms frames, repeated x2)")
    p.add_argument("--vec", default=None, help="hubert vec npy (20 ms frames, repeated x2)")
    p.add_argument("--pit", default=None, help="pitch csv")
    p.add_argument("--shift", type=int, default=0, help="semitones")
    p.add_argument("--out", default="svc_out.wav")
    p.add_argument("--chunk-batch", type=int, default=1,
                   help="chunks per model call, stacked on the batch axis")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def save_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """float32 [-1, 1] -> int16 WAV."""
    pcm = np.clip(np.asarray(audio, np.float32) * MAX_WAV_VALUE,
                  -MAX_WAV_VALUE, MAX_WAV_VALUE - 1)
    wavfile.write(path, sr, pcm.astype(np.int16))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    missing = [f"--{k}" for k in ("ppg", "vec", "pit") if getattr(args, k) is None]
    if missing:
        raise SystemExit(
            f"missing {', '.join(missing)}: the feature extractors (whisper, hubert, "
            "crepe) are not ported to PyTorch yet; pass precomputed features")
    hp = load_config(args.config)
    model = pipeline.build_infer_model(hp, device=args.device)
    pipeline.load_svc_model(args.model, model)

    spk = np.load(args.spk)
    ppg = np.repeat(np.load(args.ppg), 2, 0)  # 320 -> 160-hop x2
    vec = np.repeat(np.load(args.vec), 2, 0)
    pit = pipeline.load_csv_pitch(args.pit)
    print("pitch shift: ", args.shift)
    pit = pipeline.shift_pitch(pit, args.shift)

    audio, source = pipeline.svc_infer(
        model, DummyRetrieval(), spk, pit, ppg, vec, hp, return_source=True,
        chunk_batch=args.chunk_batch, device=args.device)
    save_wav("svc_out_pit.wav", source, hp.data.sampling_rate)
    save_wav(args.out, audio, hp.data.sampling_rate)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
