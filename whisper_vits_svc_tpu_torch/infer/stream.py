"""Streaming (block-wise) voice conversion (JAX whisper_vits_svc_tpu/infer/stream.py).

Features arrive at the 160-hop frame rate; each `push` takes a block of
frames and returns that block's samples:

  * the prior encoder and the flow see [left context | new block], and only
    the new block's samples are emitted (the same approximation the chunk
    overlap of offline synthesis makes);
  * the NSF excitation of the new block continues from a carried phase, so
    the streamed excitation equals the whole utterance's; the context's
    excitation is rolled back from that phase as the JAX class does it;
  * every block is one forward of `SynthesizerInfer` at the fixed
    [context + block] shape, on the model's device (the card unless the
    caller asks for the CPU; its snakes launch the Hopper kernel there).

The prior noise is drawn from a CPU torch.Generator seeded with `seed`, one
draw per block, then moved to the device: the card and the CPU get the same
noise. It cannot match the JAX package's PRNG, so the two are compared at
noise_scale=0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.synthesizer import SynthesizerInfer
from ..nn.nsf import source_hn_nsf
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.profiling import span

N_HARMONICS = 11  # the fundamental and 10 harmonics of the NSF source


def model_on(model: torch.nn.Module, device) -> torch.device:
    """The device the caller asked for (the card by default; raises without
    CUDA), after checking that `model` lives there."""
    asked = resolve_device(device)
    dev = next(model.parameters()).device
    if dev.type != asked.type:
        raise ValueError(f"model is on {dev}, the stream was asked for {asked}")
    return dev


class StreamingSvc:
    def __init__(self, model: SynthesizerInfer, spk: np.ndarray, hp: Config,
                 block_frames: int = 100, context_frames: int = 50,
                 noise_scale: float = 1.0, seed: int = 0,
                 device: str | torch.device | None = "cuda"):
        self.dev = model_on(model, device)
        self.model = model
        self.hop = hp.data.hop_length
        self.sr = hp.data.sampling_rate
        self.block = block_frames
        self.context = context_frames
        self.noise_scale = noise_scale
        self.spk = torch.as_tensor(np.asarray(spk, np.float32))[None].to(self.dev)
        self.noise_gen = torch.Generator().manual_seed(seed)
        self._total = context_frames + block_frames
        self._length = torch.tensor([self._total], device=self.dev)
        self.extractor = None
        self._pushes = 0  # the unit id of the push's spans

        self.phase = torch.zeros((1, N_HARMONICS), dtype=torch.float32, device=self.dev)
        self.ctx_ppg = np.zeros((context_frames, hp.vits.ppg_dim), np.float32)
        self.ctx_vec = np.zeros((context_frames, hp.vits.vec_dim), np.float32)
        self.ctx_pit = np.zeros((context_frames,), np.float32)
        self.ctx_valid = 0

    def _source(self, pit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The window's excitation [1, total*hop, 1] and the phase after the
        new block: the block continues the carried phase, the context's is
        rolled back from it (JAX infer/stream.py:76-86, float32, the same
        order of operations)."""
        c = self.context
        src_new, phase_out = source_hn_nsf(pit[:, c:], self.hop, self.sr, rng=None,
                                           phase0=self.phase, return_phase=True)
        harmonics = torch.arange(1, N_HARMONICS + 1, device=self.dev)
        inc = torch.sum(pit[:, :c, None] * harmonics * (self.hop / self.sr), dim=1)
        phase_ctx = self.phase - (inc - torch.floor(inc))
        src_ctx = source_hn_nsf(pit[:, :c], self.hop, self.sr, rng=None,
                                phase0=phase_ctx - torch.floor(phase_ctx))
        return torch.cat([src_ctx, src_new], dim=1), phase_out

    def attach_extractor(self, extractor) -> None:
        """Attach a stream_extract.StreamingExtractor for the audio-in API.
        Its 16 kHz block must map to at most this converter's block_frames
        at 100 fps: block_samples // 320 * 2 <= block_frames."""
        assert extractor.block // 160 <= self.block, (
            "extractor block emits more frames than the synthesis block")
        self.extractor = extractor

    def push_audio(self, samples16k: np.ndarray) -> np.ndarray:
        """16 kHz source block -> 32 kHz converted audio, through the
        streaming extractors; the output trails the input by the
        extractor's lag (default 80 ms) plus the block buffering."""
        ppg2, vec2, pit = self.extractor.push(samples16k)
        if len(pit) == 0:
            return np.zeros(0, np.float32)
        return self.push(ppg2, vec2, pit)

    def flush_audio(self) -> np.ndarray:
        """Drain the extractor's lag tail at the end of the stream."""
        ppg2, vec2, pit = self.extractor.flush()
        if len(pit) == 0:
            return np.zeros(0, np.float32)
        return self.push(ppg2, vec2, pit)

    def push(self, ppg: np.ndarray, vec: np.ndarray, pit: np.ndarray) -> np.ndarray:
        """Feed at most `block_frames` of features; returns n * hop samples.
        A short block is zero-padded to the block inside and its output cut
        to its frames."""
        n = ppg.shape[0]
        assert n <= self.block, f"push at most {self.block} frames"
        self._pushes += 1
        with span("svc.push", unit=self._pushes), torch.inference_mode():
            with span("svc.push.prep"):
                pad = self.block - n
                ppg_b = np.pad(ppg.astype(np.float32), ((0, pad), (0, 0)))
                vec_b = np.pad(vec.astype(np.float32), ((0, pad), (0, 0)))
                pit_b = np.pad(pit.astype(np.float32), (0, pad))
                full_ppg = np.concatenate([self.ctx_ppg, ppg_b])
                full_vec = np.concatenate([self.ctx_vec, vec_b])
                full_pit = np.concatenate([self.ctx_pit, pit_b])
                noise = None
                if self.noise_scale != 0:
                    noise = torch.randn((1, self._total, self.model.inter_channels),
                                        generator=self.noise_gen)
            with span("svc.push.upload"):
                if noise is not None:
                    noise = noise.to(self.dev)
                pit_t = torch.from_numpy(full_pit)[None].to(self.dev)
                ppg_t = torch.from_numpy(full_ppg)[None].to(self.dev)
                vec_t = torch.from_numpy(full_vec)[None].to(self.dev)
            with span("svc.push.source"):
                source, phase = self._source(pit_t)
            with span("svc.push.forward"):
                out = self.model(ppg_t, vec_t, pit_t, self.spk, self._length, source,
                                 self.noise_scale, noise=noise)
            with span("svc.push.readback"):
                audio = out[0, self.context * self.hop :, 0].cpu().numpy()
            self.phase = phase
            self.ctx_ppg = full_ppg[-self.context :]
            self.ctx_vec = full_vec[-self.context :]
            self.ctx_pit = full_pit[-self.context :]
            self.ctx_valid = min(self.ctx_valid + n, self.context)
        return audio[: n * self.hop]
