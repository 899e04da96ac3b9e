"""Seeded random weights of the audio front end in the published checkpoint
layouts: whisper's `{dims, model_state_dict}` with every encoder tensor in
float16 (as large-v2.pt stores them, all n_audio_layer blocks), HuBERT-soft's
state_dict (its pre-training parameters included) and torchcrepe's. Each
model's leaves come from one uniform draw on the device, in the order of
the reference's state_dict (benchmark/reference/extract.py):

  * a kernel of shape [O, ...] in +-1/sqrt(numel / O), the fan-in rule of
    weights.py;
  * a norm's gain (the 1-d `weight` of a LayerNorm, GroupNorm or
    BatchNorm) in 1 +- 0.1, a bias or other 1-d leaf in +-0.1;
  * BatchNorm's running_mean in +-0.1 and running_var in 1 +- 0.1, so
    that no variance is negative; num_batches_tracked 0;
  * a weight-norm gain (`weight_g`) the norm of its `weight_v` over every
    dim but the one the gain keeps (dim 2 for HuBERT's positional
    convolution), so that the normalised kernel starts equal to weight_v.

The reference is given the same tensors, whisper's as float16 values.
"""

from __future__ import annotations

import torch

from .reference.extract import Crepe, HubertSoft, WhisperEncoder, sinusoids, whisper_encoder

def _shapes(factory) -> dict:
    with torch.device("meta"):
        module = factory()
    return {k: v.shape for k, v in module.state_dict().items()}


def _gain_dim(shape: torch.Size) -> int:
    """The dim a weight-norm gain keeps: its one axis longer than 1."""
    return next((d for d, n in enumerate(shape) if n != 1), 0)


def make_leaves(shapes: dict, seed: int, device, dtype: torch.dtype = torch.float32) -> dict:
    """{name: tensor} by the rules above, drawn on `device`, each leaf kept
    on the CPU in `dtype` (num_batches_tracked in int64)."""
    drawn = [k for k, s in shapes.items()
             if not k.endswith(("num_batches_tracked", "weight_g"))]
    sizes = [shapes[k].numel() for k in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    out = {}
    for name, part in zip(drawn, flat.split(sizes)):
        shape = shapes[name]
        u = part.view(shape)
        if name.endswith("running_var"):
            t = 1.0 + 0.1 * u
        elif len(shape) >= 2:
            t = u / (shape.numel() / shape[0]) ** 0.5
        elif name.endswith("weight"):
            t = 1.0 + 0.1 * u
        else:
            t = 0.1 * u
        out[name] = t.to(dtype).cpu()
    for name, shape in shapes.items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.int64)
        elif name.endswith("weight_g"):
            v = out[name[: -len("weight_g")] + "weight_v"].float()
            keep = _gain_dim(shape)
            g = v.square().sum(dim=tuple(d for d in range(v.dim()) if d != keep),
                               keepdim=True).sqrt()
            out[name] = g.reshape(shape).to(dtype)
    return {k: out[k] for k in shapes}


def whisper_checkpoint(dims: dict, seed: int, device) -> dict:
    """{dims, model_state_dict}: the encoder's n_audio_layer blocks under
    "encoder." in float16, with the positional table, on the CPU."""
    sd = make_leaves(_shapes(lambda: WhisperEncoder(
        dims["n_mels"], dims["n_audio_ctx"], dims["n_audio_state"], dims["n_audio_head"],
        dims["n_audio_layer"])), seed, device, torch.float16)
    msd = {f"encoder.{k}": v for k, v in sd.items()}
    msd["encoder.positional_embedding"] = sinusoids(dims["n_audio_ctx"],
                                                    dims["n_audio_state"]).half()
    return {"dims": dict(dims), "model_state_dict": msd}


def hubert_state_dict(n_layers: int, seed: int, device) -> dict:
    return make_leaves(_shapes(lambda: HubertSoft(n_layers)), seed, device)


def crepe_state_dict(capacity: str, seed: int, device) -> dict:
    return make_leaves(_shapes(lambda: Crepe(capacity)), seed, device)


def reference_whisper_state(ckpt: dict) -> dict:
    """The cut reference encoder's state_dict from a whisper checkpoint:
    the kept blocks, float16 values as float32, no positional table."""
    msd = ckpt["model_state_dict"]
    return {k: msd["encoder." + k].float() for k in _shapes(lambda: whisper_encoder(ckpt["dims"]))}
