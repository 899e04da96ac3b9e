#!/usr/bin/env python3
"""How chip_smoke.py's training check moves with its CPU reference, on one
NVIDIA GPU.

    python3 train_check_probe.py [--threads 1 4 8] [--repeat 2]

`[train-card-vs-cpu]` holds the card's training-step gradients (base width,
2 x 100 frames, frozen noise, the CPU taking the card's ReLU/abs branches)
to a CPU reference at 1e-3 relative L2 per parameter. This runs that check
with the CPU side in float32 on the process's default thread count
(`--repeat` times), on each `--threads` count, and in float64, and prints
the host (CPU model, cores, torch's threads) and per variant: the worst
parameter gradients, the share within 1e-3, each audio loss term's
gradient with respect to the audio, G's VJP of one fixed d audio, the
branch flips and the CPU side's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys

import torch

import chip_smoke as cs
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict
from whisper_vits_svc_tpu_torch.utils.device import resolve_device


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def summary(cmp: dict) -> dict:
    rel = [r for r, _ in cmp["grad_rel"]]
    return dict(
        worst=[(float(f"{r:.4e}"), n) for r, n in cmp["grad_rel"][:4]],
        within=round(100.0 * sum(r <= cs.TRAIN_GRAD_REL_L2 for r in rel) / len(rel), 2),
        median=float(f"{sorted(rel)[len(rel) // 2]:.3e}"),
        loss=float(f"{max(cmp['loss_rel'].values()):.3e}"),
        terms={k: float(f"{v:.4e}") for k, v in cmp["term_rel"].items()},
        vjp=float(f"{cmp['vjp_rel'][0][0]:.3e}"), flips=cmp["flips"],
        cpu_s=round(cmp["cpu_s"], 2))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_check_probe: CUDA is not available", file=sys.stderr)
        return 1
    p = argparse.ArgumentParser()
    p.add_argument("--threads", type=int, nargs="*", default=[1, 4, 8])
    p.add_argument("--repeat", type=int, default=2)
    args = p.parse_args()
    resolve_device("cuda")
    print(json.dumps(dict(gpu=torch.cuda.get_device_name(0), cpu=cpu_model(),
                          cpu_count=os.cpu_count(),
                          affinity=len(os.sched_getaffinity(0)),
                          torch_threads=torch.get_num_threads(),
                          torch=torch.__version__)), flush=True)
    hp = config_from_dict(BASE_MODEL_CONFIG)
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cuda")
    variants = [("float32", None)] * args.repeat + [("float32", n) for n in args.threads]
    variants.append(("float64", None))
    for dtype, threads in variants:
        cmp = cs.train_card_vs_cpu(hp, g_state.model, d_state.model, "cuda",
                                   getattr(torch, dtype), threads)
        print(json.dumps(dict(cpu=dtype, threads=threads or torch.get_num_threads())
                         | summary(cmp)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
