"""Serving artifacts of the synthesis graph and the extractors, on
torch.export (JAX whisper_vits_svc_tpu/infer/serving.py, on jax.export).

An artifact is one self-contained `.pt2` file (torch.export.save) with the
weights baked in: a host loads it with torch.export.load and calls it, with
no model code, no config and no checkpoint conversion at serve time.

    export_synthesis(params, hp, "svc_serving.pt2", chunk_frames=2520)
    fn = load_synthesis("svc_serving.pt2")
    wav = fn(ppg, vec, pit, spk, lengths, source, seed)

The synthesis artifact is shape-specialised to one chunk geometry (the
chunked pipeline pads every chunk to out_chunk + 2 * hop_frame frames). The
exported program takes the prior noise [B, T, inter_channels] as an input:
a program cannot hold a torch.Generator, so `load_synthesis` returns the JAX
signature and draws that noise from a CPU generator seeded with `seed`, as
the port's other draws are made, then moves it to the artifact's device.

The snake kernel stays in the artifact. torch.export cannot trace its
ctypes call, so on the card every SnakeAlias reaches it through the
operator `svc::snake_alias` (ops/snake_cuda.py::snake_alias_op), which the
trace keeps as one node; the loaders import that module before
torch.export.load, which finds the operator by name. CREPE's convolution
kernel stays in its extractor artifact the same way, through
`svc::crepe_conv` (ops/crepe_conv_cuda.py::crepe_conv_op). A CPU artifact
holds the plain chain, as the CPU runs it everywhere.

An exported graph keeps the device it was traced on (constants made in
forward, such as the NSF and mel tables, are baked in), so one file serves
one device: with several `platforms`, each device gets its own file,
`<stem>.<device><suffix>` (svc_serving.cuda.pt2, svc_serving.cpu.pt2), and
the loader takes the file for the device it is asked for.
"""

from __future__ import annotations

import os
from collections.abc import Mapping, Sequence

import torch
from torch import nn

# register svc::snake_alias and svc::crepe_conv for the loaders
from ..ops import crepe_conv_cuda, snake_cuda  # noqa: F401
from ..utils.config import Config
from ..utils.device import resolve_device


class _SynthesisGraph(nn.Module):
    """One chunk through SynthesizerInfer with the noise as an input, the
    float inputs cast to `compute_dtype`, float32 out."""

    def __init__(self, model: nn.Module, compute_dtype: torch.dtype | None):
        super().__init__()
        self.model = model if compute_dtype is None else model.to(compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, ppg, vec, pit, spk, lengths, source, noise):
        dt = self.compute_dtype
        if dt is not None:
            ppg, vec, spk, source, noise = (x.to(dt) for x in (ppg, vec, spk, source, noise))
        out = self.model(ppg, vec, pit, spk, lengths, source, 1.0, noise=noise)
        return out.float()


def _synthesis_graph(params: Mapping[str, torch.Tensor], hp: Config,
                     compute_dtype: torch.dtype | None, device) -> _SynthesisGraph:
    """The inference graph on `device` with `params`, a SynthesizerInfer
    state_dict."""
    from .pipeline import build_infer_model

    model = build_infer_model(hp, device=device)
    model.load_state_dict({k: v.to(device) for k, v in params.items()}, strict=True)
    return _SynthesisGraph(model, compute_dtype).eval()


def draw_noise(seed: int, shape: Sequence[int], device) -> torch.Tensor:
    """The prior noise of one call: N(0, 1) from a CPU generator seeded with
    `seed`, moved to `device`."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen).to(device)


def _seeded(graph, noise_shape, device):
    """(ppg, vec, pit, spk, lengths, source, seed) -> graph(..., noise)."""

    def fn(ppg, vec, pit, spk, lengths, source, seed):
        noise = draw_noise(seed, (ppg.shape[0], ppg.shape[1], noise_shape[-1]), device)
        with torch.inference_mode():
            return graph(ppg, vec, pit, spk, lengths, source, noise)

    return fn


def build_synthesis_fn(params, hp: Config, compute_dtype: torch.dtype | None = None,
                       device: str | torch.device | None = "cuda"):
    """-> f(ppg, vec, pit, spk, lengths, source, seed) with the weights
    captured, on `device` (the card by default), eager: what the artifact
    computes. `seed` drives the prior-noise draw, so a server varies the
    noise per chunk like the CLI's per-chunk draws; the same seed gives the
    same waveform."""
    dev = resolve_device(device)
    graph = _synthesis_graph(params, hp, compute_dtype, dev)
    return _seeded(graph, (hp.vits.inter_channels,), dev)


def device_path(path: str, device: str) -> str:
    """`<stem>.<device><suffix>`: the file of one device when an artifact is
    written for several."""
    stem, suffix = os.path.splitext(path)
    return f"{stem}.{device}{suffix}"


def _platform_paths(path: str, platforms: Sequence[str]) -> list[tuple[str, str]]:
    if len(platforms) == 1:
        return [(platforms[0], path)]
    return [(p, device_path(path, p)) for p in platforms]


def export_synthesis(params, hp: Config, path: str, chunk_frames: int = 2520, batch: int = 1,
                     platforms: Sequence[str] | None = None,
                     compute_dtype: torch.dtype | None = None) -> int:
    """Write the synthesis graph of one chunk geometry to `path`; returns the
    bytes written (all files).

    chunk_frames=2520 is the pipeline's static chunk (25 s + 2 x 100 ms of
    overlap at 100 frames a second, reference svc_inference.py:96-98).
    platforms: "cuda", "cpu" or both (default: the card)."""
    hop = hp.data.hop_length
    b, t, total = batch, chunk_frames, 0
    for platform, dst in _platform_paths(path, platforms or ("cuda",)):
        dev = resolve_device(platform)
        graph = _synthesis_graph(params, hp, compute_dtype, dev)
        args = (torch.zeros(b, t, hp.vits.ppg_dim, device=dev),
                torch.zeros(b, t, hp.vits.vec_dim, device=dev),
                torch.full((b, t), 200.0, device=dev),
                torch.zeros(b, hp.vits.spk_dim, device=dev),
                torch.full((b,), t, dtype=torch.int64, device=dev),
                torch.zeros(b, t * hop, 1, device=dev),
                torch.zeros(b, t, hp.vits.inter_channels, device=dev))
        total += export_jitted(graph, args, dst)
    return total


def _resolve_artifact(path: str, device: str | None) -> str:
    if device is not None and not os.path.isfile(path):
        return device_path(path, device)
    return path


def load_synthesis(path: str, device: str | None = None):
    """A synthesis artifact -> f(ppg, vec, pit, spk, lengths, source, seed),
    the inputs on the artifact's device. With `device`, the file written for
    that device is taken where `path` itself is not there."""
    program = torch.export.load(_resolve_artifact(path, device))
    noise = _user_inputs(program)[-1]
    return _seeded(program.module(), tuple(noise.shape), noise.device)


def _user_inputs(program) -> list:
    """The (fake) tensors of an exported program's inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in names]


def export_jitted(fn: nn.Module, args: tuple, path: str) -> int:
    """Export `fn` at the shapes, dtypes and device of the example `args`
    and write it to `path`; returns the file's size."""
    fn.eval()
    with torch.no_grad():
        program = torch.export.export(fn, tuple(args))
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_exported(path: str, device: str | None = None):
    """Any artifact -> a callable module (torch.export.load(...).module())."""
    return torch.export.load(_resolve_artifact(path, device)).module()


class _WhisperServe(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, wav):
        from ..models.whisper import log_mel_spectrogram

        return self.model(log_mel_spectrogram(wav))


class _CrepeServe(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, frames):
        from ..models.crepe import normalize_frames

        return self.model(normalize_frames(frames))


def export_extractor(kind: str, model: nn.Module, path: str, *, batch: int = 1,
                     platforms: Sequence[str] | None = None) -> int:
    """Serving artifacts of the feature extractors (weights baked in), each
    at the device of `model` unless `platforms` names others:

    kind='whisper': [B, 240000] 16 kHz wav (one 15 s window, WINDOW_SAMPLES,
        whisper/inference.py:37) -> log-mel -> PPG [B, 750, n_state].
    kind='hubert': [B, 320000] 16 kHz wav (a 20 s window,
        hubert/inference.py:30) -> soft units [B, 1000, 256].
    kind='crepe': [N, 1024] raw windows -> normalize -> [N, 360] bin
        probabilities (N = batch; the reference's batch is 512)."""
    if kind == "whisper":
        from ..models.whisper import WINDOW_SAMPLES

        wrapper, shape = _WhisperServe(model), (batch, WINDOW_SAMPLES)
    elif kind == "hubert":
        wrapper, shape = model, (batch, 20 * 16000)
    elif kind == "crepe":
        wrapper, shape = _CrepeServe(model), (batch, 1024)
    else:
        raise ValueError(f"unknown extractor kind {kind!r}")
    own = next(model.parameters()).device
    total = 0
    for platform, dst in _platform_paths(path, platforms or (own.type,)):
        dev = resolve_device(platform)
        wrapper.to(dev)
        total += export_jitted(wrapper, (torch.zeros(shape, device=dev),), dst)
    wrapper.to(own)
    return total
