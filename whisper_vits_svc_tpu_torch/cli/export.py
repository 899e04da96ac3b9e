"""The svc_export CLI (JAX whisper_vits_svc_tpu/cli/export.py; reference
svc_export.py:48-57): strips a trainer checkpoint to inference-only, and
optionally writes the torch.export serving artifact.

    python -m whisper_vits_svc_tpu_torch.cli.export --checkpoint chkpt/name/name_0005.pth \
        [--out sovits5.0_export.pth] [--artifact svc_serving.pt2 --config configs/base.yaml
        --chunk-frames 2520 --platforms cuda,cpu --bf16] [--device cuda|cpu]

--checkpoint takes the port's `.pth` (or a reference `.pth`) or a JAX `.ckpt`.
--artifact PATH is the JAX CLI's --stablehlo PATH: the same serving graph,
as a `.pt2` of torch.export (infer/serving.py). The artifact is traced on
--device (the card by default; without CUDA the CLI refuses to start unless
given --device cpu), or on each device of --platforms, one file each.
"""

from __future__ import annotations

import argparse

import torch

from ..train import checkpoint as ckpt
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="svc_export")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", default="sovits5.0_export.pth")
    p.add_argument("--artifact", default=None, metavar="PATH",
                   help="also write a self-contained torch.export serving artifact "
                        "(weights baked in; see infer/serving.py)")
    p.add_argument("--config", default=None, help="config (required with --artifact)")
    p.add_argument("--chunk-frames", type=int, default=2520,
                   help="static chunk geometry of the serving artifact")
    p.add_argument("--platforms", default=None,
                   help="comma list of cuda and cpu (default: --device); with two, "
                        "one file each, <stem>.<device><suffix>")
    p.add_argument("--bf16", action="store_true",
                   help="bake bf16 weights and compute into the serving artifact")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.artifact and not args.config:
        p.error("--artifact requires --config")
    device = resolve_device(args.device)

    payload = (ckpt.load_torch_pretrain(args.checkpoint)
               if args.checkpoint.endswith((".pth", ".pt")) else ckpt.load(args.checkpoint))
    ckpt.export_inference(args.out, payload["model_g"])
    print(f"exported inference checkpoint -> {args.out}")

    if args.artifact:
        from ..infer import pipeline, serving
        from ..utils.config import load_config

        hp = load_config(args.config)
        # the weights, key-tolerant; serving builds its own kernel-free graph
        model = pipeline.load_svc_model(args.out, pipeline.build_infer_model(hp, device="cpu"))
        n = serving.export_synthesis(
            model.state_dict(), hp, args.artifact, chunk_frames=args.chunk_frames,
            platforms=(tuple(args.platforms.split(",")) if args.platforms
                       else (device.type,)),
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        print(f"exported serving artifact -> {args.artifact} ({n} bytes)")


if __name__ == "__main__":
    main()
