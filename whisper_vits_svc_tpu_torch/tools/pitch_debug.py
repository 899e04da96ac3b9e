"""Dump a train-time F0 cache (.pit.npy) to the human-editable CSV format
(JAX tools/pitch_debug.py; reference pitch/debug.py).

    python -m whisper_vits_svc_tpu_torch.tools.pitch_debug -p X.pit.npy
        [-o pitch_debug.csv]

Writes rows "Xm Ys Zms,f0", the format `cli.inference --pit` reads, so a
pitch cache can be inspected and edited in a spreadsheet. Host only.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..infer.pipeline import save_csv_pitch


def main(argv=None):
    p = argparse.ArgumentParser(prog="pitch_debug")
    p.add_argument("-p", "--pit", required=True, help="path to .pit.npy")
    p.add_argument("-o", "--out", default="pitch_debug.csv")
    args = p.parse_args(argv)
    pitch = np.load(args.pit)
    save_csv_pitch(pitch, args.out)
    print(f"wrote {args.out} ({len(pitch)} frames)")


if __name__ == "__main__":
    main()
