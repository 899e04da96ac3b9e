"""The remaining CLIs (JAX whisper_vits_svc_tpu/cli/misc.py; reference
svc_inference_shift.py, svc_inference_batch.py, svc_inference_post.py,
svc_merge.py, svc_eva.py, svc_train_retrieval.py):

    python -m whisper_vits_svc_tpu_torch.cli.misc <name> [arguments]

with <name> one of shift, batch, post, merge, eva, train-retrieval. The
three that run a model (shift and batch: synthesis; post: the silero VAD)
take --device and run on the card unless given --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..utils.audio_io import load_wav, save_wav


def inference_shift_main(argv=None):
    """Synthesis at every pitch shift in [shift_l, shift_r] semitones
    (svc_inference_shift.py:61-102), the features extracted once."""
    from ..infer import pipeline
    from ..infer.retrieval import DummyRetrieval
    from ..utils.config import load_config
    from ..utils.device import resolve_device
    from . import inference as inf

    p = inf.build_argparser()
    p.prog = "svc_inference_shift"
    p.add_argument("--shift_l", type=int, default=0)
    p.add_argument("--shift_r", type=int, default=0)
    args = p.parse_args(argv)
    assert args.shift_l >= -12 and args.shift_r <= 12 and args.shift_l <= args.shift_r

    device = resolve_device(args.device)
    hp = load_config(args.config)
    inf.auto_extract(args, device)
    model = pipeline.build_infer_model(hp, device=device)
    pipeline.load_svc_model(args.model, model)
    spk = np.load(args.spk)
    ppg = np.repeat(np.load(args.ppg), 2, 0)
    vec = np.repeat(np.load(args.vec), 2, 0)
    pit0 = pipeline.load_csv_pitch(args.pit)
    for shift in range(args.shift_l, args.shift_r + 1):
        pit = pipeline.shift_pitch(pit0.copy(), shift)
        audio = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, hp,
                                   device=device)
        save_wav(f"svc_out_{shift}.wav", audio, hp.data.sampling_rate)
        print(f"wrote svc_out_{shift}.wav")


def inference_batch_main(argv=None):
    """Every .wav of a folder through the inference CLI
    (svc_inference_batch.py:35-44), in the process; the svc_tmp.* features
    are removed before each file."""
    from ..utils.device import resolve_device
    from . import inference as inf

    p = argparse.ArgumentParser(prog="svc_inference_batch")
    p.add_argument("--config", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--folder", required=True)
    p.add_argument("--spk", required=True)
    p.add_argument("--shift", type=int, default=0)
    p.add_argument("--out", default="svc_out_batch")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    wavs = sorted(f for f in os.listdir(args.folder) if f.endswith(".wav"))
    for f in wavs:
        # the JAX package's batch CLI names crepe_pretrain/full.pth, where
        # the inference CLI's default is crepe/assets/full.pth
        sub = argparse.Namespace(
            config=args.config, model=args.model,
            wave=os.path.join(args.folder, f), spk=args.spk,
            ppg=None, vec=None, pit=None, shift=args.shift,
            enable_retrieval=False, retrieval_index_prefix="",
            retrieval_ratio=0.5, n_retrieval_vectors=3,
            whisper_ckpt="whisper_pretrain/large-v2.pt",
            hubert_ckpt="hubert_pretrain/hubert-soft-0d54a1f4.pt",
            crepe_ckpt="crepe_pretrain/full.pth",
            out=os.path.join(args.out, f), device=args.device,
        )
        for tmp in inf.TMP_FEATURES.values():
            if os.path.isfile(tmp):
                os.remove(tmp)
        inf.main_from_namespace(sub)
        print(f"{f} -> {sub.out}")


def inference_post_main(argv=None):
    """The VAD hard-mute post filter (svc_inference_post.py:31-51): silero
    from --vad-model when the file exists, else the energy VAD."""
    from ..infer.post import apply_vad_mask
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(prog="svc_inference_post")
    p.add_argument("--ref", required=True, help="original 16k input wav")
    p.add_argument("--svc", required=True, help="32k svc output wav")
    p.add_argument("--out", default="svc_out_post.wav")
    p.add_argument("--vad-model", default="vad/assets/silero_vad.jit",
                   help="silero TorchScript weights; energy-VAD fallback if absent")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    vad_model = None
    if os.path.isfile(args.vad_model):
        from ..models.silero_vad import load_silero_vad

        vad_model = load_silero_vad(args.vad_model, device)

    ref, _ = load_wav(args.ref, target_sr=16000)
    svc, sr = load_wav(args.svc)
    out = apply_vad_mask(svc, ref, vad_model=vad_model)
    save_wav(args.out, out, sr)
    print(f"wrote {args.out}")


def merge_main(argv=None):
    """Two models lerped by --ratio, or N averaged with --models; a `.pth`
    {"model_g": state_dict} out."""
    from ..infer.tools import average_model, merge_model

    p = argparse.ArgumentParser(prog="svc_merge")
    p.add_argument("--model1", required=True)
    p.add_argument("--model2", default=None)
    p.add_argument("--models", nargs="*", default=None, help="N-way average")
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--out", default="svc_merge.pth")
    args = p.parse_args(argv)
    if args.models:
        average_model([args.model1] + args.models, args.out)
    else:
        merge_model(args.model1, args.model2, args.out, args.ratio)
    print(f"wrote {args.out}")


def eva_main(argv=None):
    from ..infer.tools import mix_speakers

    p = argparse.ArgumentParser(prog="svc_eva")
    p.add_argument("--spk", nargs="+", required=True, help="singer npy paths")
    p.add_argument("--weights", nargs="+", type=float, required=True)
    p.add_argument("--out", default="eva.spk.npy")
    args = p.parse_args(argv)
    mix_speakers(args.spk, args.weights, args.out)
    print(f"wrote {args.out}")


def train_retrieval_main(argv=None):
    """Per-speaker retrieval banks (svc_train_retrieval.py)."""
    from ..infer.retrieval import build_index

    p = argparse.ArgumentParser(prog="svc_train_retrieval")
    p.add_argument("--base-dir", default="data_svc")
    p.add_argument("--out-dir", default="data_svc/indexes")
    p.add_argument("--compress-threshold", type=int, default=200_000)
    p.add_argument("--n-clusters", type=int, default=10_000)
    args = p.parse_args(argv)

    for feat in ("whisper", "hubert"):
        root = os.path.join(args.base_dir, feat)
        if not os.path.isdir(root):
            continue
        for spk in sorted(os.listdir(root)):
            files = sorted(os.path.join(root, spk, f)
                           for f in os.listdir(os.path.join(root, spk)) if f.endswith(".npy"))
            if not files:
                continue
            os.makedirs(os.path.join(args.out_dir, spk), exist_ok=True)
            out = os.path.join(args.out_dir, spk, f"{feat}.npz")
            bank = build_index(files, out, threshold=args.compress_threshold,
                               n_clusters=args.n_clusters)
            print(f"{spk}/{feat}: {bank.shape} -> {out}")


ENTRY_POINTS = {
    "shift": inference_shift_main,
    "batch": inference_batch_main,
    "post": inference_post_main,
    "merge": merge_main,
    "eva": eva_main,
    "train-retrieval": train_retrieval_main,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ENTRY_POINTS:
        raise SystemExit("usage: python -m whisper_vits_svc_tpu_torch.cli.misc "
                         f"{{{','.join(ENTRY_POINTS)}}} [arguments]")
    ENTRY_POINTS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
