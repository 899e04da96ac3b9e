"""Chunked SVC synthesis: the svc_infer runtime.

Semantics of whisper_vits_svc_tpu/infer/pipeline.py (reference
svc_inference.py:77-134): the NSF excitation is generated once for the whole
utterance and sliced per chunk, so its phase is continuous across chunks;
fixed-size chunks overlap by `hop_frame` frames, trimmed at the seams. Every
chunk is right-padded to `out_chunk + 2*hop_frame` frames exactly as the JAX
package pads it: the generator has no length mask, so the last chunk's real
samples depend on that padding.

Prior noise comes from a CPU torch.Generator seeded with `seed`, one draw
per chunk in plan order, then moved to the device: the same features and
seed give the same noise on the card and on the CPU, and for any chunk_batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import from_jax_params, load_jax_ckpt, load_tolerant, torch_load_weights
from ..models.synthesizer import SynthesizerInfer
from ..nn.conv import fold_weight_norm
from ..utils.audio_io import MAX_WAV_VALUE
from ..utils.config import Config
from ..utils.device import resolve_device


def build_infer_model(hp: Config, device: str | torch.device | None = "cuda",
                      seed: int = 0, snake_variant: str = "direct",
                      amp_fused_iter: bool = False,
                      fast_edges: bool = False, fold_wn: bool = False) -> SynthesizerInfer:
    """The inference graph for `hp`, with random weights made from `seed`
    (JAX initializers), in eval mode on `device` (the card by default).

    `snake_variant` ("direct", "strips" or "mma") names the forward snake
    kernel; `amp_fused_iter` runs each AMP dilation iteration of the narrow
    stages as one fused kernel. Both keep the parameters and the function of
    the default path. `fast_edges` zero-pads inside every snake's FIRs (the
    outermost ~6 samples of each call differ, trimmed by the overlap between
    chunks) and runs the plain chain in place of the kernels, as the JAX
    package turns its Pallas snake off for it (infer/pipeline.py:125-156).
    `fold_wn` folds every weight norm into a plain kernel once
    (nn/conv.py::fold_weight_norm), as the reference's remove_weight_norm()
    before inference does: the convolutions then skip the norm on each call,
    and `load_svc_model` folds a checkpoint's weight-norm pairs on the way
    in."""
    dev = resolve_device(device)
    model = SynthesizerInfer(
        ppg_dim=hp.vits.ppg_dim,
        vec_dim=hp.vits.vec_dim,
        spk_dim=hp.vits.spk_dim,
        inter_channels=hp.vits.inter_channels,
        hidden_channels=hp.vits.hidden_channels,
        filter_channels=hp.vits.filter_channels,
        upsample_rates=tuple(hp.gen.upsample_rates),
        upsample_kernel_sizes=tuple(hp.gen.upsample_kernel_sizes),
        upsample_initial_channel=hp.gen.upsample_initial_channel,
        resblock_kernel_sizes=tuple(hp.gen.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(tuple(d) for d in hp.gen.resblock_dilation_sizes),
        sampling_rate=hp.data.sampling_rate,
        enc_p_layers=hp.vits.get("enc_p_layers", 6),
        flow_wn_layers=hp.vits.get("flow_wn_layers", 4),
        n_flows=hp.vits.get("n_flows", 4),
        snake_variant=snake_variant,
        amp_fused_iter=amp_fused_iter,
        snake_exact_edges=not fast_edges,
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    if fold_wn:
        model.load_state_dict(fold_weight_norm(model.state_dict()))
    return model.to(dev).eval()


def load_svc_model(path: str, model: SynthesizerInfer) -> SynthesizerInfer:
    """Key-tolerant load into `model` from a JAX `.ckpt` (its `model_g`
    tree) or a reference `.pth`/`.pt` (its `model_g` state_dict)."""
    if path.endswith((".pth", ".pt")):
        sd = torch_load_weights(path)["model_g"]
    else:
        sd = from_jax_params(load_jax_ckpt(path)["model_g"])
    for k in load_tolerant(model, sd):
        print(f"{k} is not in the checkpoint")
    return model


def pitch2source_bucketed(model: SynthesizerInfer, pit: np.ndarray,
                          device: torch.device, bucket_frames: int = 1000) -> torch.Tensor:
    """Whole-utterance excitation [1, t*hop, 1] on `device`, computed over
    the f0 zero-padded to a whole number of buckets, as the JAX package
    does (exact for the real prefix: the phase cumsum is a prefix scan and
    f0 = 0 frames emit nothing in the deterministic mode)."""
    t = len(pit)
    tp = max(bucket_frames, -(-t // bucket_frames) * bucket_frames)
    f0 = torch.zeros((1, tp), dtype=torch.float32)
    f0[0, :t] = torch.from_numpy(np.asarray(pit, np.float32))
    hop = int(math.prod(model.upsample_rates))
    return model.pitch2source(f0.to(device))[:, : t * hop]


def shift_pitch(pit: np.ndarray, semitones: float) -> np.ndarray:
    """2^(s/12) scaling with a print of the source statistics
    (svc_inference.py:187-199)."""
    if semitones == 0:
        return pit
    voiced = pit[pit > 0]
    if len(voiced):
        print(f"source pitch statics: mean={voiced.mean():0.1f}, "
              f"min={voiced.min():0.1f}, max={voiced.max():0.1f}")
    return pit * 2 ** (semitones / 12)


def _chunk_plan(len_min: int, out_chunk: int, hop_frame: int):
    """The reference's chunk walk (svc_inference.py:101-131) as a static
    plan: per chunk (cut_s, cut_e) frame window plus the output trim."""
    plan = []
    out_index = 0
    while out_index < len_min:
        if out_index == 0:
            cut_s, cut_s_out = 0, 0
        else:
            cut_s, cut_s_out = out_index - hop_frame, hop_frame
        if out_index + out_chunk + hop_frame > len_min:
            cut_e, cut_e_out = len_min, None
        else:
            cut_e, cut_e_out = out_index + out_chunk + hop_frame, -hop_frame
        plan.append((cut_s, cut_e, cut_s_out, cut_e_out))
        out_index += out_chunk
    return plan


def svc_infer(model: SynthesizerInfer, retrieval, spk: np.ndarray, pit: np.ndarray,
              ppg: np.ndarray, vec: np.ndarray, hp: Config, noise_scale: float = 1.0,
              seed: int = 0, out_chunk: int = 1000, hop_frame: int = 10,
              return_source: bool = False, chunk_batch: int = 1,
              device: str | torch.device | None = "cuda",
              compute_dtype: torch.dtype | None = None):
    """Features -> float32 waveform [S] (and the excitation if asked).

    spk [spk_dim], pit [T] Hz, ppg [T, ppg_dim], vec [T, vec_dim] at the
    model's frame rate. `model` must be on `device` (the card by default).
    chunk_batch > 1 runs that many chunks per model call, stacked on the
    batch axis.

    compute_dtype=torch.bfloat16 runs the synthesis graph in bfloat16, as
    the JAX package's _chunk_program does (infer/pipeline.py:71-80): the
    parameters (weight norm then computed from bfloat16 g and v), the
    ppg / vec / spk inputs, the prior noise and the excitation, made in
    float32, are cast; pit and the lengths are not; the waveform comes back
    as float32. The caller's model is not changed: the cast parameters are
    swapped in for the call (torch.func.functional_call).
    """
    asked = resolve_device(device)
    dev = next(model.parameters()).device
    if dev.type != asked.type:
        raise ValueError(f"model is on {dev}, svc_infer was asked for {asked}")
    hop = hp.data.hop_length
    len_min = min(len(pit), len(vec), len(ppg))
    pit = np.asarray(pit, np.float32)[:len_min]
    vec = np.asarray(vec, np.float32)[:len_min]
    ppg = np.asarray(ppg, np.float32)[:len_min]
    spk_t = torch.from_numpy(np.asarray(spk, np.float32))[None].to(dev)
    chunk_max = out_chunk + 2 * hop_frame
    plan = _chunk_plan(len_min, out_chunk, hop_frame)
    noise_gen = torch.Generator().manual_seed(seed)
    pieces: list[np.ndarray] = []
    own = next(model.parameters()).dtype
    dt = compute_dtype or own
    run = model
    if dt != own:
        cast = {k: v.to(dt) for k, v in model.state_dict().items()}

        def run(*args, **kwargs):
            return torch.func.functional_call(model, cast, args, kwargs)
    with torch.inference_mode():
        source = pitch2source_bucketed(model, pit, dev)  # [1, S, 1]
        for g0 in range(0, len(plan), chunk_batch):
            group = plan[g0 : g0 + chunk_batch]
            ppg_c, vec_c, pit_c, src_c, lens, noise = [], [], [], [], [], []
            for cut_s, cut_e, _, _ in group:
                t = cut_e - cut_s
                pad = chunk_max - t
                ppg_c.append(np.pad(retrieval.retriv_whisper(ppg[cut_s:cut_e]),
                                    ((0, pad), (0, 0))))
                vec_c.append(np.pad(retrieval.retriv_hubert(vec[cut_s:cut_e]),
                                    ((0, pad), (0, 0))))
                pit_c.append(np.pad(pit[cut_s:cut_e], (0, pad)))
                src_c.append(F.pad(source[0, cut_s * hop : cut_e * hop], (0, 0, 0, pad * hop)))
                lens.append(t)
                if noise_scale != 0:
                    noise.append(torch.randn((chunk_max, model.inter_channels),
                                             generator=noise_gen))
            out = run(
                torch.from_numpy(np.stack(ppg_c)).to(dev, dt),
                torch.from_numpy(np.stack(vec_c)).to(dev, dt),
                torch.from_numpy(np.stack(pit_c)).to(dev),
                spk_t.expand(len(group), -1).to(dt),
                torch.tensor(lens, device=dev),
                torch.stack(src_c).to(dt),
                noise_scale,
                noise=torch.stack(noise).to(dev, dt) if noise else None,
            )
            out = out[..., 0].float().cpu().numpy()
            for gi, (cut_s, cut_e, s_out, e_out) in enumerate(group):
                chunk_wav = out[gi, : (cut_e - cut_s) * hop]
                pieces.append(chunk_wav[s_out * hop : None if e_out is None else e_out * hop])
        audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        if return_source:
            return audio, source[0, :, 0].cpu().numpy()
    return audio


def source2wav(source: np.ndarray) -> np.ndarray:
    """Excitation -> int16 debug waveform (reference generator.py:167-173)."""
    audio = np.squeeze(source) * MAX_WAV_VALUE
    return np.clip(audio, -MAX_WAV_VALUE, MAX_WAV_VALUE - 1).astype(np.int16)


def save_csv_pitch(pitch: np.ndarray, path: str):
    """Human-editable F0 CSV "Xm Ys Zms,f0" (pitch/inference.py:102-111)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, p in enumerate(pitch):
            t = i * 10
            minute = t // 60000
            seconds = (t - minute * 60000) // 1000
            millisecond = t % 1000
            print(f"{minute}m {seconds}s {millisecond:3d},{int(p)}", file=f)


def load_csv_pitch(path: str) -> np.ndarray:
    """Reads the CSV back (integer Hz, pitch/inference.py:113-119)."""
    pitch = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                pitch.append(int(line.strip().split(",")[-1]))
    return np.asarray(pitch, np.float32)
