"""The yardstick's arithmetic: the snake's calls, bytes and operations from
the configuration's shapes, its bound on the card, and model FLOPs counted
on the reference.

Bound of one call = the larger of bytes / HBM rate and operations / f32
rate (the snake runs on the CUDA cores). Bytes count each input read once
and each output written once: forward x, y and alpha, beta; backward x, dy
read, dx written, alpha, beta read, dalpha, dbeta written. Operations per
output element: forward two 6-tap up FIRs (24), the snake on two phases
(2 x 5, sin counted once), two 6-tap down FIRs (24) = 58; backward the up
FIRs again (24), the down FIRs' adjoints (24), sincos and the derivative on
two phases (2 x 9), the dalpha / dbeta terms (2 x 6), the up FIRs' adjoints
(24) = 102.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

SNAKE_OPS_PER_ELEM = 58
SNAKE_BWD_OPS_PER_ELEM = 102


def stage_shapes(model_cfg: dict, batch: int, frames: int) -> list[tuple[tuple[int, int, int], int]]:
    """((B, C, T), snake calls) per generator stage for `frames` latent
    frames: two snakes a dilation of each AMP block of a stage, plus the
    final activation at the last stage."""
    gen = model_cfg["gen"]
    out, t = [], frames
    per_stage = 2 * sum(len(d) for d in gen["resblock_dilation_sizes"])
    for i, u in enumerate(gen["upsample_rates"]):
        t *= u
        c = gen["upsample_initial_channel"] // 2 ** (i + 1)
        out.append(((batch, c, t), per_stage))
    shape, n = out[-1]
    out[-1] = (shape, n + 1)
    return out


def snake_bound_s(shapes, peaks: dict, backward: bool = False, itemsize: int = 4) -> float:
    """Sum of the per-call bounds (seconds) over `shapes` [((B, C, T), calls)]."""
    total = 0.0
    for (b, c, t), calls in shapes:
        n = b * c * t
        if backward:
            n_bytes = (3 * n + 4 * c) * itemsize
            ops = SNAKE_BWD_OPS_PER_ELEM * n
        else:
            n_bytes = (2 * n + 2 * c) * itemsize
            ops = SNAKE_OPS_PER_ELEM * n
        total += calls * max(n_bytes / peaks["hbm_bytes_per_s"], ops / peaks["float32_flops_per_s"])
    return total


def count_flops(fn) -> int:
    """Matmul and convolution FLOPs of fn(), run with the meta device as the
    default: no memory, no kernel."""
    with FlopCounterMode(display=False) as counter, torch.device("meta"):
        fn()
    return int(counter.get_total_flops())
