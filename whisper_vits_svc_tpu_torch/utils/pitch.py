"""F0 quantization (reference vits/utils.py:13-33)."""

from __future__ import annotations

import math

import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Mel-scale quantization of F0 into bins 1..255, in float32 on f0's
    device; round-half-up via floor(x + 0.5). Returns int64 bins."""
    f0_mel = 1127.0 * torch.log(1.0 + f0.float() / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = f0_mel.clamp_min(1.0).clamp_max(float(F0_BIN - 1))
    return torch.floor(f0_mel + 0.5).long()
