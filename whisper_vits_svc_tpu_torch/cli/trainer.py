"""The trainer CLI (JAX whisper_vits_svc_tpu/cli/trainer.py; reference
svc_trainer.py:13-43):

    python -m whisper_vits_svc_tpu_torch.cli.trainer -c configs/base.yaml -n name
        [-p chkpt/name/name_0005.pth] [--max-epochs N] [--max-steps N]
        [--profile-dir DIR] [--device cuda|cpu] [--process-id R]

Runs on the card; without CUDA it refuses to start unless given --device cpu.
Data-parallel training reads the config's `dist` section (coordinator_address
host:port, num_processes, process_id): start one process per rank with the
same config, each with its own --process-id (rank r trains on cuda:r; gloo
on the CPU with --device cpu).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..train.loop import train
from ..utils.config import load_config
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="svc_trainer")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-n", "--name", required=True)
    p.add_argument("-p", "--checkpoint_path", default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps 3..12 to this dir")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank, in place of the config's dist.process_id")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    hp = load_config(args.config)
    if args.process_id is not None:
        hp["dist"] = {**(hp.get("dist") or {}), "process_id": args.process_id}
    assert hp.data.hop_length == 320, "hop_length must be 320 (reference svc_trainer.py:27)"
    np.random.seed(hp.train.seed)
    return train(hp, args.name, args.checkpoint_path, args.max_epochs, args.max_steps,
                 profile_dir=args.profile_dir, device=device)


if __name__ == "__main__":
    main()
