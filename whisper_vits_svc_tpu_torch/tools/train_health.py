"""The training-health run: the trainer CLI on the learnable synthetic
dataset, and the held-out validation mel it reaches.

    python -m whisper_vits_svc_tpu_torch.tools.train_health --ws WS --name NAME
        [--steps 2100] [--config base.json] [--out summary.json] [--device cuda|cpu]

Builds WS with `make_synth_dataset` (its defaults: 60 utterances of
2.2-3.9 s, 6 speakers, seed 0, 10 held out) unless WS/files/train.txt
exists, writes WS/NAME.json (the base config, `configs/base.yaml`'s values
unless --config names another, e.g. one with `train.bf16_discriminator:
true`, with batch 8, the log cadence info 50 steps / eval 20 / save 50
epochs, 3 checkpoints kept, and the loop's NaN auto-resume at x0.4 the
learning rate), and runs `cli.trainer` from WS for --steps steps. Prints
and writes to --out: the validation mel at each evaluation and the g / mel
/ d losses at each info line, each with its step and epoch, the NaN
guard's lines (a divergence and the auto-resume after it), the step
reached and the wall and steps/s to it (a stretch re-run after an
auto-resume counted once), the peak device memory, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import torch

from ..cli import trainer as cli_trainer
from ..train.loop import TrainDivergence
from ..utils.config import BASE_MODEL_CONFIG, load_config
from ..utils.device import resolve_device
from . import make_synth_dataset

# the log cadence of the JAX package's 2100-step run (docs/TRAIN_RUN_r04.md),
# in steps (info) and epochs (eval, save)
HEALTH_LOG = dict(info_interval=50, eval_interval=20, save_interval=50, keep_ckpts=3)
# a divergence resumes the newest checkpoint with the learning rate x0.4
# (the loop's nan_autoresume), as the JAX run recovered: 5e-5 -> 2e-5
HEALTH_NAN = dict(nan_autoresume=True, nan_lr_factor=0.4)

_VAL = re.compile(r"^epoch (\d+) \| validation mel ([-\d.naninf]+) \| step (\d+)")
_INFO = re.compile(r"^epoch (\d+) \| g .* \| step (\d+)$")
_RESUMED = re.compile(r"^Resumed from (\S+) at epoch (\d+), step (\d+)")


def health_config(base, batch_size: int = 8, log: dict = HEALTH_LOG) -> dict:
    """`base` (a config tree) as a plain dict with the health run's batch
    size, log cadence and divergence recovery (HEALTH_NAN); the filelists,
    checkpoints and logs are the workspace's own (relative paths, read from
    WS)."""
    hp = json.loads(json.dumps({k: v for k, v in base.items() if k != "raw"}))
    hp["train"].update(batch_size=batch_size, **HEALTH_NAN)
    hp["data"].update(training_files="files/train.txt", validation_files="files/valid.txt")
    hp["log"].update(log, pth_dir="chkpt", log_dir="logs")
    return hp


class _Tee(io.TextIOBase):
    """stdout that is passed on and kept."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_trainer(argv: list[str], out=None) -> tuple[str, TrainDivergence | None]:
    """cli.trainer's main, its stdout kept and passed on to `out` (sys.stdout
    by default). Returns (stdout, the TrainDivergence that stopped it or
    None)."""
    tee = _Tee(sys.stdout if out is None else out)
    div = None
    with contextlib.redirect_stdout(tee):
        try:
            cli_trainer.main(argv)
        except TrainDivergence as e:
            div = e
            print(f"TrainDivergence: {e}")
    return tee.text(), div


def trajectory(log_dir: str, name: str, stdout: str) -> dict:
    """The run's records from logs/NAME/metrics.jsonl, each with the epoch
    the trainer printed beside its step: {"validation": [{step, epoch,
    mel}], "train": [{step, epoch, loss_g, loss_m, loss_d, ...}],
    "resumed": [{path, epoch, step}]}. A resume repeats its checkpoint's
    epoch, so a step can appear twice; records keep the file's order."""
    val_epochs, info_epochs, resumed = [], {}, []
    for line in stdout.splitlines():
        if m := _VAL.match(line):
            val_epochs.append((int(m[3]), int(m[1])))
        elif m := _INFO.match(line):
            info_epochs[int(m[2])] = int(m[1])
        elif m := _RESUMED.match(line):
            resumed.append(dict(path=m[1], epoch=int(m[2]), step=int(m[3])))
    with open(os.path.join(log_dir, name, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = [r for r in records if "validation_mel_loss" in r]
    if [s for s, _ in val_epochs] != [r["step"] for r in val]:
        raise ValueError(f"validation steps printed {val_epochs} differ from metrics.jsonl's "
                         f"{[r['step'] for r in val]}")
    return dict(
        validation=[dict(step=r["step"], epoch=e, mel=r["validation_mel_loss"])
                    for r, (_, e) in zip(val, val_epochs)],
        train=[dict(r, epoch=info_epochs.get(r["step"])) for r in records if "loss_g" in r],
        resumed=resumed)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="train_health")
    ap.add_argument("--ws", required=True, help="workspace (built if it has no filelists)")
    ap.add_argument("--name", required=True)
    ap.add_argument("--steps", type=int, default=2100)
    ap.add_argument("--config", default=None,
                    help="base config (.yaml or .json); configs/base.yaml's values by default")
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    ws = os.path.abspath(args.ws)
    out = os.path.abspath(args.out) if args.out else None

    t0 = time.perf_counter()
    if not os.path.isfile(os.path.join(ws, "files", "train.txt")):
        make_synth_dataset.main(["--out", ws, "--device", args.device])
    build_s = time.perf_counter() - t0

    hp = health_config(load_config(args.config) if args.config else BASE_MODEL_CONFIG)
    cfg = os.path.join(ws, f"{args.name}.json")
    with open(cfg, "w") as f:
        json.dump(hp, f, indent=1)

    cwd = os.getcwd()
    os.chdir(ws)  # the filelists hold paths relative to the workspace
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stdout, div = run_trainer(["-c", cfg, "-n", args.name, "--max-steps", str(args.steps),
                                   "--device", args.device])
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = trajectory("logs", args.name, stdout)
    finally:
        os.chdir(cwd)

    reached = div.step if div is not None else args.steps
    summary = dict(
        name=args.name, steps=args.steps, steps_reached=reached,
        bf16_discriminator=bool(hp["train"].get("bf16_discriminator", False)),
        batch_size=hp["train"]["batch_size"], accum_step=hp["train"]["accum_step"],
        log=HEALTH_LOG, workspace_s=build_s, wall_s=wall, steps_per_s=reached / wall,
        nan_guard=[line for line in stdout.splitlines() if line.startswith("NaN guard:")],
        halted=None if div is None else dict(step=div.step,
                                             last_healthy_step=div.last_healthy_step),
        peak_bytes=torch.cuda.max_memory_allocated() if on_card else None,
        device=torch.cuda.get_device_name(0) if on_card else "cpu",
        card=card_line() if on_card else None, **traj)
    for v in traj["validation"]:
        print(f"[health] {args.name} step {v['step']} epoch {v['epoch']}: "
              f"validation mel {v['mel']:.4f}")
    for r in traj["train"]:
        print(f"[health] {args.name} step {r['step']} epoch {r['epoch']}: g {r['loss_g']:.4f} "
              f"mel {r['loss_m']:.4f} d {r['loss_d']:.4f}")
    print(f"[health] {args.name}: step {reached} reached in {wall:.1f} s "
          f"({summary['steps_per_s']:.3f} steps/s, model builds, validation and checkpoints "
          f"included); NaN guard {summary['nan_guard']}; halted {summary['halted']}; "
          "peak device memory "
          + (f"{summary['peak_bytes'] / 2**30:.2f} GiB" if on_card else "not measured (CPU)")
          + f" | {summary['card'] or 'cpu'}", flush=True)
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
