"""Model FLOPs of the audio front end a live push, counted on the
reference (reference/extract.py) at the stream's shapes with
work.count_flops: the matmuls and convolutions on the meta device, nothing
run. The log-mel's FFT is no matmul and is not counted; its 80 x 201 mel
projection is."""

from __future__ import annotations

import torch

from .reference.extract import (WINDOW_SAMPLES, Crepe, HubertSoft, crepe_head,
                                crepe_probabilities, hubert_window, mel_filters, whisper_encoder)
from .work import count_flops


def whisper_flops(dims: dict, samples: int = WINDOW_SAMPLES) -> int:
    """The cut encoder on a window of `samples` (a whole 15 s one by
    default), with the mel projection."""
    frames = samples // 160

    def run():
        enc = whisper_encoder(dims)
        mel = torch.from_numpy(mel_filters()).to("meta") @ torch.zeros(1, 201, frames)
        enc(mel)

    return count_flops(run)


def hubert_flops(n_layers: int, block: int, context_seconds: float) -> int:
    """HuBERT-soft on a whole [context | block] window."""
    a, b = hubert_window(10**9, block, context_seconds)
    return count_flops(lambda: HubertSoft(n_layers).units(torch.zeros(1, b - a)))


def crepe_flops(capacity: str, frames: int) -> int:
    """CREPE on `frames` frames (the frames a push needs, not the rows of
    the program's static batch)."""
    return count_flops(lambda: crepe_probabilities(Crepe(capacity), torch.zeros(frames, 1024)))


def crepe_frames_of_push(k: int, block: int) -> int:
    """Frames the k-th push (from 0) of a stream completes: the newest frame
    whose 1024 samples have arrived, less the last push's."""
    return crepe_head((k + 1) * block) - (crepe_head(k * block) if k else -1)
