"""svc_inference CLI (JAX whisper_vits_svc_tpu/cli/inference.py; reference
svc_inference.py:206-241).

    python -m whisper_vits_svc_tpu_torch.cli.inference --config configs/base.yaml \
        --model model.pth --spk spk.npy --wave song.wav [--shift 2] \
        [--f0-engine crepe|salience|swipe|yin|pyin|dio|praat] [--bf16] \
        [--enable-retrieval --retrieval-index-prefix data_svc/index/spk_] \
        [--out svc_out.wav] [--device cuda]

Features not given (--ppg, --vec, --pit) are extracted from --wave in the
process: whisper PPG (--whisper-ckpt), HuBERT-soft units (--hubert-ckpt) and
F0 from --f0-engine (CREPE from --crepe-ckpt by default; the other six need
no checkpoint), written to svc_tmp.ppg.npy, svc_tmp.vec.npy and
svc_tmp.pit.csv in the working directory and reused from there when
present. Then chunked synthesis, in bfloat16 with --bf16, writes --out and
svc_out_pit.wav (the excitation) as 16-bit WAVs. Everything runs on the
card (dio and praat are numpy on the host in both packages); without CUDA
the CLI refuses to start unless given --device cpu. Checkpoints load with
torch.load(weights_only=True).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..infer import pipeline
from ..infer.retrieval import create_retrieval
from ..models import crepe, dio, f0_alt, hubert, praat, salience, swipe, whisper
from ..utils import audio_io
from ..utils.config import load_config
from ..utils.device import resolve_device

F0_ENGINES = ("crepe", "salience", "swipe", "yin", "pyin", "dio", "praat")
TMP_FEATURES = {"ppg": "svc_tmp.ppg.npy", "vec": "svc_tmp.vec.npy", "pit": "svc_tmp.pit.csv"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="svc_inference")
    p.add_argument("--config", required=True, help="yaml config")
    p.add_argument("--model", required=True, help="JAX .ckpt or reference .pth")
    p.add_argument("--wave", default=None,
                   help="input wav at any rate; needed unless --ppg, --vec and --pit are given")
    p.add_argument("--spk", required=True, help="speaker embedding npy")
    p.add_argument("--ppg", default=None, help="whisper ppg npy (auto if absent)")
    p.add_argument("--vec", default=None, help="hubert vec npy (auto if absent)")
    p.add_argument("--pit", default=None, help="pitch csv (auto if absent)")
    p.add_argument("--shift", type=int, default=0, help="semitones")
    p.add_argument("--enable-retrieval", action="store_true")
    p.add_argument("--retrieval-index-prefix", default="",
                   help="the banks are <prefix>whisper.npz and <prefix>hubert.npz")
    p.add_argument("--retrieval-ratio", type=float, default=0.5)
    p.add_argument("--n-retrieval-vectors", type=int, default=3)
    p.add_argument("--whisper-ckpt", default="whisper_pretrain/large-v2.pt")
    p.add_argument("--hubert-ckpt", default="hubert_pretrain/hubert-soft-0d54a1f4.pt")
    p.add_argument("--crepe-ckpt", default="crepe/assets/full.pth")
    p.add_argument("--f0-engine", default="crepe", choices=F0_ENGINES,
                   help="pitch extractor for the auto --pit path (the reference exposes "
                        "these as compute_f0_* in pitch/inference.py)")
    p.add_argument("--out", default="svc_out.wav")
    p.add_argument("--bf16", action="store_true",
                   help="run the synthesis graph in bfloat16")
    p.add_argument("--chunk-batch", type=int, default=1,
                   help="chunks per model call, stacked on the batch axis")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def auto_extract(args, device: torch.device) -> None:
    """Fills args.ppg / vec / pit with the svc_tmp.* paths when absent and
    extracts from args.wave those files that do not exist yet."""
    todo = []
    for key, path in TMP_FEATURES.items():
        if getattr(args, key) is None:
            setattr(args, key, path)
            if not os.path.isfile(path):
                todo.append(key)
    if not todo:
        return
    if args.wave is None:
        raise SystemExit(f"--wave is needed to extract {', '.join('--' + k for k in todo)}; "
                         "pass it, or pass precomputed --ppg, --vec and --pit")
    audio16, _ = audio_io.load_wav(args.wave, target_sr=16000)
    if "ppg" in todo:
        print(f"Auto run : whisper ppg -> {args.ppg}")
        model = whisper.load_whisper_encoder(args.whisper_ckpt, device)
        ppg = whisper.pred_ppg(model, audio16, rng=torch.Generator().manual_seed(0))
        np.save(args.ppg, ppg, allow_pickle=False)
        del model
    if "vec" in todo:
        print(f"Auto run : hubert vec -> {args.vec}")
        model = hubert.load_hubert_soft(args.hubert_ckpt, device)
        np.save(args.vec, hubert.pred_vec(model, audio16), allow_pickle=False)
        del model
    if "pit" in todo:
        engine = getattr(args, "f0_engine", "crepe")
        print(f"Auto run : {engine} pitch -> {args.pit}")
        pipeline.save_csv_pitch(extract_f0(engine, audio16, args.crepe_ckpt, device), args.pit)


def extract_f0(engine: str, audio16: np.ndarray, crepe_ckpt: str,
               device: torch.device) -> np.ndarray:
    """F0 at the 160-sample hop of 16 kHz audio from one of F0_ENGINES,
    called as the JAX CLI's auto_extract calls it."""
    if engine == "crepe":
        model = crepe.load_crepe(crepe_ckpt, device=device)
        return crepe.compute_f0_sing(model, audio16, np.random.default_rng(0))
    if engine == "salience":
        return salience.compute_f0_sing_salience(audio16, device=device)
    if engine == "dio":
        return dio.compute_f0_dio(audio16, 16000, hop=160)
    if engine == "praat":
        return praat.compute_f0_mouth(audio16, 16000, hop=160)
    if engine == "swipe":
        return swipe.swipe(audio16, 16000, hop=160, device=device)[0]
    if engine == "yin":
        return f0_alt.yin(audio16, fs=16000, hop=160, device=device)[0]
    if engine == "pyin":
        return f0_alt.pyin(audio16, fs=16000, hop=160, device=device)[0]
    raise ValueError(f"unknown f0 engine {engine!r}; one of {F0_ENGINES}")


def main(argv=None):
    main_from_namespace(build_argparser().parse_args(argv))


def main_from_namespace(args):
    """The CLI on parsed arguments (the shift and batch CLIs build their own
    namespaces): bf16, chunk_batch, f0_engine and device may be absent."""
    device = resolve_device(getattr(args, "device", "cuda"))
    auto_extract(args, device)

    hp = load_config(args.config)
    model = pipeline.build_infer_model(hp, device=device)
    pipeline.load_svc_model(args.model, model)
    prefix = args.retrieval_index_prefix
    retrieval = create_retrieval(args.enable_retrieval, args.retrieval_ratio,
                                 args.n_retrieval_vectors, prefix + "whisper.npz",
                                 prefix + "hubert.npz", device=device)

    spk = np.load(args.spk)
    ppg = np.repeat(np.load(args.ppg), 2, 0)  # 320 -> 160-hop x2
    vec = np.repeat(np.load(args.vec), 2, 0)
    pit = pipeline.load_csv_pitch(args.pit)
    print("pitch shift: ", args.shift)
    pit = pipeline.shift_pitch(pit, args.shift)

    audio, source = pipeline.svc_infer(
        model, retrieval, spk, pit, ppg, vec, hp, return_source=True,
        chunk_batch=getattr(args, "chunk_batch", 1), device=device,
        compute_dtype=torch.bfloat16 if getattr(args, "bf16", False) else None)
    audio_io.save_wav("svc_out_pit.wav", source, hp.data.sampling_rate)
    audio_io.save_wav(args.out, audio, hp.data.sampling_rate)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
