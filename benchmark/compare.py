"""The comparisons that decide `correct`, and the control's precision switch.

Waveforms are compared by their largest absolute difference (the output is
tanh, in [-1, 1]); a length mismatch reads as infinity. A training step is
compared by its losses (relative gaps) and, leaf by leaf, by the gap
between the program's norm and the reference's of a leaf's first gradient
and of its change over the first steps, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient is
under 1e-3 of the median leaf's move under AdamW by rounding alone (an
attention key's bias under the softmax): they are left out of both, by that
rule and not by name.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

NEGLIGIBLE_GRAD = 1e-3


@contextmanager
def tf32(on: bool):
    """TF32 convolutions and matmuls on the card while inside (the control:
    float32 with TF32 off is the configuration's precision)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def max_abs(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float("inf") if not np.all(np.isfinite(d)) else float(d.max())


def rel_gap(a: float, b: float) -> float:
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def counted(ref_grad_norms: dict) -> set:
    med = float(np.median(list(ref_grad_norms.values())))
    return {k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE_GRAD * med}


def leaf_gaps(prog: dict, ref: dict, leaves: set) -> dict:
    """|prog - ref| / max(ref, median ref) of every counted leaf (inf where
    the program's norm is not finite)."""
    med = float(np.median([ref[k] for k in leaves]))
    out = {}
    for k in sorted(leaves):
        p = prog.get(k, float("nan"))
        out[k] = abs(p - ref[k]) / max(ref[k], med) if np.isfinite(p) else float("inf")
    return out


def worst_and_median(gaps: dict) -> tuple[float, str, float]:
    """(worst gap, its leaf, the median leaf's gap)."""
    worst = max(gaps, key=lambda k: gaps[k])
    return gaps[worst], worst, float(np.median(list(gaps.values())))
