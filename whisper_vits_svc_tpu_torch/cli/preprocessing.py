"""The svc_preprocessing CLI (JAX whisper_vits_svc_tpu/cli/preprocessing.py;
reference svc_preprocessing.py:14-25): one in-process driver in place of the
reference's 10 sequential subprocesses. Stages are idempotent; a rerun
resumes where it stopped.

    python -m whisper_vits_svc_tpu_torch.cli.preprocessing --dataset-raw dataset_raw \
        -c configs/base.yaml [--whisper-ckpt W --hubert-ckpt H --crepe-ckpt C
        --speaker-ckpt S] [--serial] [--device cuda|cpu]
    python -m whisper_vits_svc_tpu_torch.cli.preprocessing --stage cdc|trim -i IN -o OUT

Each extractor is loaded on --device (the card by default; without CUDA the
CLI refuses to start unless given --device cpu). A stage whose checkpoint
is missing is skipped with a "[skip] ... checkpoint missing" line. The run
ends with a dry run of the dataset through SvcDataset and BucketBatcher.
"""

from __future__ import annotations

import argparse
import os

from ..data.preprocess import (
    Extractors, cdc_directory, dataset_dry_run, preprocess, trim_directory,
)
from ..utils.config import load_config
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="svc_preprocessing")
    p.add_argument("--dataset-raw", default="dataset_raw")
    p.add_argument("--out", default="data_svc")
    p.add_argument("--files", default="files")
    p.add_argument("-c", "--config", default="configs/base.yaml")
    p.add_argument("--whisper-ckpt", default="whisper_pretrain/large-v2.pt")
    p.add_argument("--hubert-ckpt", default="hubert_pretrain/hubert-soft-0d54a1f4.pt")
    p.add_argument("--crepe-ckpt", default="crepe_pretrain/full.pth")
    p.add_argument("--speaker-ckpt", default="speaker_pretrain/best_model.pth.tar")
    p.add_argument("--batch-windows", type=int, default=8,
                   help="extractor windows batched per device call (packed across utterances)")
    p.add_argument("--io-threads", type=int, default=4)
    p.add_argument("--serial", action="store_true",
                   help="per-utterance serial loop (the A/B baseline)")
    p.add_argument("--stage", choices=["all", "cdc", "trim"], default="all",
                   help="'cdc'/'trim' run only the VCTK clean-up stages (reference "
                        "prepare/preprocess_cdc.py / preprocess_trim.py) from -i to -o")
    p.add_argument("-i", "--in-path", default=None, help="input dir for --stage cdc/trim")
    p.add_argument("-o", "--out-path", default=None, help="output dir for --stage cdc/trim")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    if args.stage in ("cdc", "trim"):
        if not args.in_path or not args.out_path:
            p.error(f"--stage {args.stage} requires -i and -o")
        fn = cdc_directory if args.stage == "cdc" else trim_directory
        n = fn(args.in_path, args.out_path)
        print(f"{args.stage}: {n} files")
        return

    device = resolve_device(args.device)
    hp = load_config(args.config)
    ex = Extractors()
    if os.path.isfile(args.crepe_ckpt):
        from ..models.crepe import load_crepe

        ex.crepe = load_crepe(args.crepe_ckpt, device=device)
    else:
        print(f"[skip] crepe checkpoint missing: {args.crepe_ckpt}")
    if os.path.isfile(args.whisper_ckpt):
        from ..models.whisper import load_whisper_encoder

        ex.whisper = load_whisper_encoder(args.whisper_ckpt, device)
    else:
        print(f"[skip] whisper checkpoint missing: {args.whisper_ckpt}")
    if os.path.isfile(args.hubert_ckpt):
        from ..models.hubert import load_hubert_soft

        ex.hubert = load_hubert_soft(args.hubert_ckpt, device)
    else:
        print(f"[skip] hubert checkpoint missing: {args.hubert_ckpt}")
    if os.path.isfile(args.speaker_ckpt):
        from ..models.speaker_encoder import load_speaker_encoder

        ex.speaker = load_speaker_encoder(args.speaker_ckpt, device)
    else:
        print(f"[skip] speaker checkpoint missing: {args.speaker_ckpt}")

    stats = preprocess(args.dataset_raw, args.out, args.files, hp.data, ex,
                       batch_windows=args.batch_windows, io_threads=args.io_threads,
                       serial=args.serial, device=device)
    print(stats)
    if stats.get("rows"):
        dataset_dry_run(hp.data, args.files, hp.train.get("batch_size", 2))
    return stats


if __name__ == "__main__":
    main()
