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

On the card the forward is one CUDA graph replay, not ~1,800 ops issued
one by one. Its shapes never change (a short block is padded to the
window), so the first push that needs it copies its inputs into static
buffers, runs the forward WARM_FORWARDS times on a side stream and
captures it; every later push copies its inputs in, replays, and reads the
output back with `.cpu()`. One graph serves every stream of one model,
window and noise scale (`graph_key`); a model whose parameters or buffers
moved (`.to()`, `load_state_dict(assign=True)`) is captured again, while an
in-place load keeps the graph, which reads the parameters where they lie.
A lock holds the shared buffers from the copies in to the read back. If
the capture raises, the error is logged once and that model and window run
op by op. On the CPU the forward runs op by op, as before.
`graph_captures`, `graph_replays` and `eager_forwards` count forwards; a
replay adds the kernel launches its capture counted to the kernels' own
counters (`KERNEL_MODULES`' `add_counts`), which the graph's launches skip.
The key is read on every push (a walk over the parameters and buffers), so
a model moved under a live stream is captured again, never replayed at the
addresses it left.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import weakref

import numpy as np
import torch

from ..models.synthesizer import SynthesizerInfer
from ..nn.nsf import source_hn_nsf
from ..ops import amp_cuda, snake_cuda
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.profiling import span

N_HARMONICS = 11  # the fundamental and 10 harmonics of the NSF source
WARM_FORWARDS = 2  # eager forwards on a side stream before a capture
GRAPH_DEVICES = ("cuda",)  # device types whose pushes replay a CUDA graph

graph_captures = 0  # push forwards captured into a CUDA graph
graph_replays = 0   # push forwards run as a replay
eager_forwards = 0  # push forwards run op by op (the CPU, or after a failed capture)

# the forward's kernel modules, whose launch counters (`counts`, `add_counts`)
# a replay adds its capture's launches to
KERNEL_MODULES = (snake_cuda, amp_cuda)

log = logging.getLogger(__name__)
_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> {window: _PushGraph}
_graphs_lock = threading.Lock()
_NO_LOCK = contextlib.nullcontext()


def model_on(model: torch.nn.Module, device) -> torch.device:
    """The device the caller asked for (the card by default; raises without
    CUDA), after checking that `model` lives there."""
    asked = resolve_device(device)
    dev = next(model.parameters()).device
    if dev.type != asked.type:
        raise ValueError(f"model is on {dev}, the stream was asked for {asked}")
    return dev


def tensor_dicts(model: torch.nn.Module) -> list[dict]:
    """The parameter and buffer dicts of every module of `model`: where
    `load_state_dict(assign=True)` puts new tensors and `.to()` new data."""
    return [d for m in model.modules() for d in (m._parameters, m._buffers) if d]


def graph_key(model: torch.nn.Module, context: int, block: int, noise_scale: float,
              dicts: list[dict] | None = None) -> tuple:
    """What a captured push forward of `model` holds fixed besides its
    shapes: the window (context, block), the noise scale (a constant of the
    captured kernels; 0 passes no noise), the parameters' dtype and the
    address of every parameter and buffer, which the graph reads in place.
    The first three pick the model's graph, the rest says whether it is
    still good. `dicts`: the model's `tensor_dicts`, if already listed."""
    tensors = [t for d in (tensor_dicts(model) if dicts is None else dicts)
               for t in d.values() if t is not None]
    return (context, block, float(noise_scale), tensors[0].dtype,
            tuple(t.data_ptr() for t in tensors))


def _kernel_counts() -> list[dict]:
    return [module.counts() for module in KERNEL_MODULES]


def _minus(after: list[dict], before: list[dict]) -> list[dict]:
    return [{name: a[name] - b[name] for name in a} for a, b in zip(after, before)]


def _warm(fn, dev: torch.device) -> None:
    """WARM_FORWARDS calls of `fn` on a side stream, as torch.cuda.graphs
    asks before a capture (cuDNN's plans, B1's build)."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARM_FORWARDS):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)


def _capture(fn, dev: torch.device) -> tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """`fn` captured into a CUDA graph, and the output tensor it writes."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


class _PushGraph:
    """The static buffers of one model's push window and, once captured, the
    CUDA graph of its forward and the output the graph writes."""

    def __init__(self, model: SynthesizerInfer, key: tuple, dev: torch.device,
                 spk_dim: int, hop: int, ppg_dim: int, vec_dim: int):
        context, block, noise_scale = key[:3]
        total = context + block
        self.key, self.noise_scale = key, noise_scale
        self.lock = threading.Lock()
        self.graph = self.out = None
        self.failed = False
        self.launches: list[dict] = []  # kernel launches a replay, as _kernel_counts
        self.ppg = torch.zeros((1, total, ppg_dim), device=dev)
        self.vec = torch.zeros((1, total, vec_dim), device=dev)
        self.pit = torch.zeros((1, total), device=dev)
        self.spk = torch.zeros((1, spk_dim), device=dev)
        self.length = torch.tensor([total], device=dev)
        self.source = torch.zeros((1, total * hop, 1), device=dev)
        self.noise = (torch.zeros((1, total, model.inter_channels), device=dev)
                      if noise_scale != 0 else None)

    def forward(self, model: SynthesizerInfer) -> torch.Tensor:
        """The model on the static buffers, op by op."""
        return model(self.ppg, self.vec, self.pit, self.spk, self.length, self.source,
                     self.noise_scale, noise=self.noise)

    def capture(self, model: SynthesizerInfer) -> None:
        """Warm the forward up, then capture it. The launches counted while
        capturing are taken back, since nothing ran, and kept for the
        replays."""
        global graph_captures
        dev = self.ppg.device
        _warm(lambda: self.forward(model), dev)
        before = _kernel_counts()
        try:
            graph, out = _capture(lambda: self.forward(model), dev)
        finally:
            launches = _minus(_kernel_counts(), before)
            for module, counted in zip(KERNEL_MODULES, launches):
                module.add_counts({name: -n for name, n in counted.items()})
        self.graph, self.out = graph, out
        self.launches = launches
        graph_captures += 1

    def replay(self) -> torch.Tensor:
        global graph_replays
        self.graph.replay()
        for module, launches in zip(KERNEL_MODULES, self.launches):
            module.add_counts(launches)
        graph_replays += 1
        return self.out


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
        self._audio_pushes = 0  # the unit id of push_audio's and flush_audio's spans
        self._tensor_dicts = tensor_dicts(model)

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
        extractor's lag (default 80 ms) plus the block buffering. Opens
        `svc.push_audio` (unit id: the stream's push_audio and flush_audio
        count) around the extractor's `svc.extract` and the `svc.push`."""
        return self._audio(self.extractor.push, samples16k)

    def flush_audio(self) -> np.ndarray:
        """Drain the extractor's lag tail at the end of the stream (the
        same spans as push_audio)."""
        return self._audio(self.extractor.flush)

    def _audio(self, extract, *args) -> np.ndarray:
        self._audio_pushes += 1
        with span("svc.push_audio", unit=self._audio_pushes):
            ppg2, vec2, pit = extract(*args)
            if len(pit) == 0:
                return np.zeros(0, np.float32)
            return self.push(ppg2, vec2, pit)

    def _graph(self) -> _PushGraph | None:
        """The graph this stream's pushes replay: on the card, shared by
        every stream of the model with this window and noise scale, made
        anew when the model's parameters moved; None on the CPU and after a
        failed capture."""
        if self.dev.type not in GRAPH_DEVICES:
            return None
        key = graph_key(self.model, self.context, self.block, self.noise_scale,
                        self._tensor_dicts)
        with _graphs_lock:
            windows = _graphs.setdefault(self.model, {})
            g = windows.get(key[:3])
            if g is None or g.key != key:
                g = windows[key[:3]] = _PushGraph(
                    self.model, key, self.dev, self.spk.shape[1], self.hop,
                    self.ctx_ppg.shape[1], self.ctx_vec.shape[1])
        return None if g.failed else g

    def _forward(self, g: _PushGraph | None, ppg_t, vec_t, pit_t, source, noise) -> torch.Tensor:
        """The window's audio [1, total*hop, 1]: a replay of `g` (captured
        first if it is new), else the model op by op."""
        global eager_forwards
        if g is not None and g.graph is None and not g.failed:
            try:
                g.capture(self.model)
            except RuntimeError as err:
                g.failed = True
                log.warning("CUDA graph capture of the push forward failed; this model and "
                            "window run op by op: %s", err)
        if g is not None and g.graph is not None:
            with span("svc.push.forward.replay"):
                return g.replay()
        eager_forwards += 1
        return self.model(ppg_t, vec_t, pit_t, self.spk, self._length, source,
                          self.noise_scale, noise=noise)

    def push(self, ppg: np.ndarray, vec: np.ndarray, pit: np.ndarray) -> np.ndarray:
        """Feed at most `block_frames` of features; returns n * hop samples.
        A short block is zero-padded to the block inside and its output cut
        to its frames."""
        n = ppg.shape[0]
        assert n <= self.block, f"push at most {self.block} frames"
        self._pushes += 1
        with span("svc.push", unit=self._pushes), torch.inference_mode():
            g = self._graph()
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
            with g.lock if g is not None else _NO_LOCK:
                with span("svc.push.upload"):
                    if g is None:
                        if noise is not None:
                            noise = noise.to(self.dev)
                        pit_t = torch.from_numpy(full_pit)[None].to(self.dev)
                        ppg_t = torch.from_numpy(full_ppg)[None].to(self.dev)
                        vec_t = torch.from_numpy(full_vec)[None].to(self.dev)
                    else:
                        if noise is not None:
                            noise = g.noise.copy_(noise)
                        pit_t = g.pit.copy_(torch.from_numpy(full_pit)[None])
                        ppg_t = g.ppg.copy_(torch.from_numpy(full_ppg)[None])
                        vec_t = g.vec.copy_(torch.from_numpy(full_vec)[None])
                        g.spk.copy_(self.spk)
                with span("svc.push.source"):
                    source, phase = self._source(pit_t)
                    if g is not None:
                        source = g.source.copy_(source)
                with span("svc.push.forward"):
                    out = self._forward(g, ppg_t, vec_t, pit_t, source, noise)
                with span("svc.push.readback"):  # a copy: the next replay rewrites a graph's output
                    audio = out[0, self.context * self.hop :, 0].to("cpu", copy=True).numpy()
            self.phase = phase
            self.ctx_ppg = full_ppg[-self.context :]
            self.ctx_vec = full_vec[-self.context :]
            self.ctx_pit = full_pit[-self.context :]
            self.ctx_valid = min(self.ctx_valid + n, self.context)
        return audio[: n * self.hop]
