"""Weights: JAX param trees and checkpoints -> the port's state_dict.

The port's parameter names are the reference torch state_dict's (the keys
whisper_vits_svc_tpu/models/convert.py reads), so a reference `.pth`
`model_g` loads directly. `from_jax_params` is the inverse of the JAX
package's `convert.synthesizer_infer`: it maps a JAX SynthesizerInfer param
tree (nested dict of arrays) back to those names, reading every depth from
the tree. `from_jax_trn_params` and `from_jax_disc_params` are the inverses
of `convert.synthesizer_trn` and `convert.discriminator`: a JAX
SynthesizerTrn tree and a JAX Discriminator tree to the training models'
state_dicts. `load_jax_ckpt` reads a JAX `.ckpt` (flax msgpack) with plain
`msgpack`, imported lazily.

Layouts: JAX Conv1d (K, I, O) -> torch (O, I, K); JAX ConvTranspose1d
(K, I, O) -> torch (I, O, K); JAX Conv2d (Kh, Kw, I, O) -> torch
(O, I, Kh, Kw); weight-norm g (1, 1, O) -> (O, 1, 1), (1, I, 1) -> (I, 1, 1)
and (1, 1, 1, O) -> (O, 1, 1, 1); Dense (I, O) -> 1x1 conv (O, I, 1) or
Linear (O, I); LayerNorm scale/bias -> gamma/beta.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _count(tree: Mapping, prefix: str) -> int:
    found = [int(m.group(1)) for k in tree if (m := re.fullmatch(rf"{prefix}_(\d+)", k))]
    return max(found) + 1 if found else 0


def _conv1d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _wn_conv1d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight_g"] = _t(np.reshape(p["g"], (-1, 1, 1)))
    sd[f"{name}.weight_v"] = _t(np.transpose(p["v"], (2, 1, 0)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _wn_convT1d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight_g"] = _t(np.reshape(p["g"], (-1, 1, 1)))
    sd[f"{name}.weight_v"] = _t(np.transpose(p["v"], (1, 2, 0)))
    sd[f"{name}.bias"] = _t(p["bias"])


def _wn_conv2d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight_g"] = _t(np.reshape(p["g"], (-1, 1, 1, 1)))
    sd[f"{name}.weight_v"] = _t(np.transpose(p["v"], (3, 2, 0, 1)))
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv1x1_from_dense(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _wn(sd: dict, name: str, p: Mapping) -> None:
    if "cond_layer" in p:
        _wn_conv1d(sd, f"{name}.cond_layer", p["cond_layer"])
    for i in range(_count(p, "in_layers")):
        _wn_conv1d(sd, f"{name}.in_layers.{i}", p[f"in_layers_{i}"])
        _wn_conv1d(sd, f"{name}.res_skip_layers.{i}", p[f"res_skip_layers_{i}"])


def rel_pos_transformer(sd: dict, name: str, p: Mapping) -> None:
    for i in range(_count(p, "attn_layers")):
        attn = p[f"attn_layers_{i}"]
        for conv in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv1x1_from_dense(sd, f"{name}.attn_layers.{i}.{conv}", attn[conv])
        sd[f"{name}.attn_layers.{i}.emb_rel_k"] = _t(attn["emb_rel_k"])
        sd[f"{name}.attn_layers.{i}.emb_rel_v"] = _t(attn["emb_rel_v"])
        for norm in ("norm_layers_1", "norm_layers_2"):
            sd[f"{name}.{norm}.{i}.gamma"] = _t(p[f"{norm}_{i}"]["scale"])
            sd[f"{name}.{norm}.{i}.beta"] = _t(p[f"{norm}_{i}"]["bias"])
        ffn = p[f"ffn_layers_{i}"]
        _conv1d(sd, f"{name}.ffn_layers.{i}.conv_1", ffn["conv_1"])
        _conv1d(sd, f"{name}.ffn_layers.{i}.conv_2", ffn["conv_2"])


def text_encoder(sd: dict, name: str, p: Mapping) -> None:
    _conv1d(sd, f"{name}.pre", p["pre"])
    _conv1d(sd, f"{name}.hub", p["hub"])
    sd[f"{name}.pit.weight"] = _t(p["pit"]["embedding"])
    rel_pos_transformer(sd, f"{name}.enc", p["enc"])
    _conv1d(sd, f"{name}.proj", p["proj"])


def coupling_block(sd: dict, name: str, p: Mapping) -> None:
    for i in range(_count(p, "flows")):
        f, t = p[f"flows_{i}"], f"{name}.flows.{2 * i}"  # flips sit at odd indices
        for conv in ("pre", "post", "snac"):
            _conv1d(sd, f"{t}.{conv}", f[conv])
        _wn(sd, f"{t}.enc", f["enc"])


def _snake(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.act.alpha"] = _t(p["act"]["alpha"])
    sd[f"{name}.act.beta"] = _t(p["act"]["beta"])


def amp_block(sd: dict, name: str, p: Mapping) -> None:
    for j in range(_count(p, "convs1")):
        _wn_conv1d(sd, f"{name}.convs1.{j}", p[f"convs1_{j}"])
        _wn_conv1d(sd, f"{name}.convs2.{j}", p[f"convs2_{j}"])
        _snake(sd, f"{name}.activations.{2 * j}", p[f"act1_{j}"])
        _snake(sd, f"{name}.activations.{2 * j + 1}", p[f"act2_{j}"])


def generator(sd: dict, name: str, p: Mapping) -> None:
    a = p["adapter"]
    sd[f"{name}.adapter.W_scale.weight"] = _t(np.asarray(a["w_scale_kernel"]).T)
    sd[f"{name}.adapter.W_scale.bias"] = _t(a["w_scale_bias"])
    sd[f"{name}.adapter.W_bias.weight"] = _t(np.asarray(a["w_bias_kernel"]).T)
    sd[f"{name}.adapter.W_bias.bias"] = _t(a["w_bias_bias"])
    _conv1d(sd, f"{name}.conv_pre", p["conv_pre"])
    for i in range(_count(p, "ups")):
        _wn_convT1d(sd, f"{name}.ups.{i}", p[f"ups_{i}"])
        _conv1d(sd, f"{name}.noise_convs.{i}", p[f"noise_convs_{i}"])
    for r in range(_count(p, "resblocks")):
        amp_block(sd, f"{name}.resblocks.{r}", p[f"resblocks_{r}"])
    _snake(sd, f"{name}.activation_post", p["activation_post"])
    _conv1d(sd, f"{name}.conv_post", p["conv_post"])


def from_jax_params(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX SynthesizerInfer params {enc_p, flow, dec} -> the port's
    state_dict (other top-level keys, e.g. enc_q of a training tree, are
    ignored)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    text_encoder(sd, "enc_p", tree["enc_p"])
    coupling_block(sd, "flow", tree["flow"])
    generator(sd, "dec", tree["dec"])
    return sd


def from_jax_trn_params(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX SynthesizerTrn params {emb_g, enc_p, speaker_classifier, enc_q,
    flow, dec} -> the port's SynthesizerTrn state_dict."""
    sd = from_jax_params(tree)
    sd["emb_g.weight"] = _t(np.asarray(tree["emb_g"]["kernel"]).T)
    sd["emb_g.bias"] = _t(tree["emb_g"]["bias"])
    for j in range(3):  # the reference Sequential holds the GRL at index 0
        _wn_conv1d(sd, f"speaker_classifier.classifier.{2 * j + 1}",
                   tree["speaker_classifier"][f"conv_{j}"])
    q = tree["enc_q"]
    _conv1d(sd, "enc_q.pre", q["pre"])
    _wn(sd, "enc_q.enc", q["enc"])
    _conv1d(sd, "enc_q.proj", q["proj"])
    return sd


def from_jax_disc_params(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX Discriminator params {mrd_i, mpd_i, msd} -> the port's
    Discriminator state_dict."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for kind in ("mrd", "mpd"):
        for i in range(_count(tree, kind)):
            d, name = tree[f"{kind}_{i}"], f"{kind.upper()}.discriminators.{i}"
            for j in range(_count(d, "convs")):
                _wn_conv2d(sd, f"{name}.convs.{j}", d[f"convs_{j}"])
            _wn_conv2d(sd, f"{name}.conv_post", d["conv_post"])
    msd = tree["msd"]
    for j in range(_count(msd, "convs")):
        _wn_conv1d(sd, f"MSD.convs.{j}", msd[f"convs_{j}"])
    _wn_conv1d(sd, "MSD.conv_post", msd["conv_post"])
    return sd


def _ndarray_from_ext(code: int, data: bytes):
    """Flax's msgpack ndarray: ExtType 1 (ndarray) or 3 (numpy scalar)
    holding a packed (shape, dtype name, C-order bytes)."""
    import msgpack

    if code not in (1, 3):
        return msgpack.ExtType(code, data)
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
    return arr if code == 1 else arr[()]


def load_jax_ckpt(path: str) -> dict:
    """Read a JAX `.ckpt` (flax.serialization.msgpack_serialize of a numpy
    tree) without flax: the payload dict, arrays as numpy."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ndarray_from_ext, raw=False)


def load_tolerant(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> list[str]:
    """Copy the model's keys present in `sd` (shapes must match); keys the
    model has and `sd` lacks keep their current values, as the reference
    loaders do (svc_inference.py:61-74). Returns the missing keys."""
    own = model.state_dict()
    missing = []
    with torch.no_grad():
        for k, v in own.items():
            src = sd.get(k, sd.get(f"module.{k}"))  # DDP-saved keys carry "module."
            if src is None:
                missing.append(k)
                continue
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(src.shape)} "
                                 f"vs model {tuple(v.shape)}")
            v.copy_(torch.as_tensor(src))
    return missing
