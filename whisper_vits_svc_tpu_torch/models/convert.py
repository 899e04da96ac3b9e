"""Weights: JAX param trees and checkpoints -> the port's state_dict.

The port's parameter names are the reference torch state_dict's (the keys
whisper_vits_svc_tpu/models/convert.py reads), so a reference `.pth`
`model_g` loads directly. `from_jax_params` is the inverse of the JAX
package's `convert.synthesizer_infer`: it maps a JAX SynthesizerInfer param
tree (nested dict of arrays) back to those names, reading every depth from
the tree. `from_jax_trn_params` and `from_jax_disc_params` are the inverses
of `convert.synthesizer_trn` and `convert.discriminator`: a JAX
SynthesizerTrn tree and a JAX Discriminator tree to the training models'
state_dicts. `from_jax_opt_state` carries a JAX optimizer state (optax
AdamW moments, the MultiSteps accumulator) into a torch AdamW state_dict.
`from_jax_whisper`, `from_jax_hubert`, `from_jax_crepe` and
`from_jax_speaker_encoder` are the inverses of the extractors' converters
(`convert_encoder`, `convert_hubert`, `convert_crepe`,
`convert_speaker_encoder`); `from_jax_silero_vad` turns the numpy tree of
the JAX package's `load_silero_vad` into the port's SileroVAD state_dict,
and `from_jax_med` a MelspecDiscriminator tree into the port's. A tree that
the JAX package's `fold_weight_norm` folded ({kernel} in place of {v, g})
converts to the folded `weight`.
`load_jax_ckpt` reads a JAX `.ckpt` (flax msgpack) with plain `msgpack`,
imported lazily; `torch_load_weights` reads a `.pth` with
`weights_only=True`; `load_generator` reads the generator of either.

Layouts: JAX Conv1d (K, I, O) -> torch (O, I, K); JAX ConvTranspose1d
(K, I, O) -> torch (I, O, K); JAX Conv2d (Kh, Kw, I, O) -> torch
(O, I, Kh, Kw); weight-norm g (1, 1, O) -> (O, 1, 1), (1, I, 1) -> (I, 1, 1)
and (1, 1, 1, O) -> (O, 1, 1, 1); Dense (I, O) -> 1x1 conv (O, I, 1) or
Linear (O, I); LayerNorm scale/bias -> gamma/beta.
"""

from __future__ import annotations

import pickle
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


def _wn_pair(sd: dict, name: str, p: Mapping, g_shape: tuple, axes: tuple) -> None:
    """A weight-norm {v, g} pair, or the {kernel} that the JAX package's
    fold_weight_norm makes of it (then a folded `weight`), and the bias."""
    if "kernel" in p:
        sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], axes))
    else:
        sd[f"{name}.weight_g"] = _t(np.reshape(p["g"], g_shape))
        sd[f"{name}.weight_v"] = _t(np.transpose(p["v"], axes))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _wn_conv1d(sd: dict, name: str, p: Mapping) -> None:
    _wn_pair(sd, name, p, (-1, 1, 1), (2, 1, 0))


def _wn_convT1d(sd: dict, name: str, p: Mapping) -> None:
    _wn_pair(sd, name, p, (-1, 1, 1), (1, 2, 0))


def _wn_conv2d(sd: dict, name: str, p: Mapping) -> None:
    _wn_pair(sd, name, p, (-1, 1, 1, 1), (3, 2, 0, 1))


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


def amp_iter_args_from_jax(p: Mapping, j: int) -> tuple[torch.Tensor, ...]:
    """Dilation iteration j of a JAX AMP block's params -> the arguments
    (k1, b1, a1, be1, k2, b2, a2, be2) of ops/amp_cuda.py::amp_iter: the two
    kernels with the weight norm folded as the JAX package folds it
    (g * v / (||v|| + 1e-12), the norm per output channel), in torch's
    (out, in, tap) order."""
    def folded(conv: Mapping) -> torch.Tensor:
        v = np.asarray(conv["v"], np.float32)  # (K, I, O)
        norm = np.sqrt(np.sum(np.square(v), axis=(0, 1), keepdims=True))
        return _t(np.transpose(np.asarray(conv["g"]) * v / (norm + 1e-12), (2, 1, 0)))

    c1, c2 = p[f"convs1_{j}"], p[f"convs2_{j}"]
    act1, act2 = p[f"act1_{j}"]["act"], p[f"act2_{j}"]["act"]
    return (folded(c1), _t(c1["bias"]), _t(act1["alpha"]), _t(act1["beta"]),
            folded(c2), _t(c2["bias"]), _t(act2["alpha"]), _t(act2["beta"]))


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


def from_jax_generator(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A JAX generator tree: a training tree (with enc_q) or an export."""
    return from_jax_trn_params(tree) if "enc_q" in tree else from_jax_params(tree)


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


def _linear(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _layer_norm(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def from_jax_whisper(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX WhisperEncoder params -> the port's WhisperEncoder state_dict
    (the reference's encoder keys without "encoder.")."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    _conv1d(sd, "conv1", tree["conv1"])
    _conv1d(sd, "conv2", tree["conv2"])
    for i in range(_count(tree, "blocks")):
        b, p = f"blocks.{i}", tree[f"blocks_{i}"]
        for proj in ("query", "key", "value", "out"):
            _linear(sd, f"{b}.attn.{proj}", p["attn"][proj])
        _layer_norm(sd, f"{b}.attn_ln", p["attn_ln"])
        _linear(sd, f"{b}.mlp.0", p["mlp_0"])
        _linear(sd, f"{b}.mlp.2", p["mlp_2"])
        _layer_norm(sd, f"{b}.mlp_ln", p["mlp_ln"])
    _layer_norm(sd, "ln_post", tree["ln_post"])
    return sd


def from_jax_hubert(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX HubertSoft params -> the port's HubertSoft state_dict (any number
    of layers)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    fe = tree["feature_extractor"]
    for i in range(7):
        _conv1d(sd, f"feature_extractor.conv{i}", fe[f"conv{i}"])
    _layer_norm(sd, "feature_extractor.norm0", fe["norm0"])
    _layer_norm(sd, "feature_projection.norm", tree["fp_norm"])
    _linear(sd, "feature_projection.projection", tree["fp_projection"])
    pos = tree["positional_embedding"]
    sd["positional_embedding.conv.weight_g"] = _t(np.reshape(pos["g"], (1, 1, -1)))
    sd["positional_embedding.conv.weight_v"] = _t(np.transpose(pos["v"], (2, 1, 0)))
    sd["positional_embedding.conv.bias"] = _t(pos["bias"])
    _layer_norm(sd, "norm", tree["norm"])
    for i in range(_count(tree, "layer")):
        b, p = f"encoder.layers.{i}", tree[f"layer_{i}"]
        sd[f"{b}.self_attn.in_proj_weight"] = _t(np.asarray(p["in_proj"]["kernel"]).T)
        sd[f"{b}.self_attn.in_proj_bias"] = _t(p["in_proj"]["bias"])
        _linear(sd, f"{b}.self_attn.out_proj", p["out_proj"])
        _linear(sd, f"{b}.linear1", p["linear1"])
        _linear(sd, f"{b}.linear2", p["linear2"])
        _layer_norm(sd, f"{b}.norm1", p["norm1"])
        _layer_norm(sd, f"{b}.norm2", p["norm2"])
    _linear(sd, "proj", tree["proj"])
    return sd


def from_jax_crepe(tree: Mapping, bn_eps: float = 0.0010000000474974513
                   ) -> "OrderedDict[str, torch.Tensor]":
    """JAX Crepe params -> the port's Crepe state_dict. The JAX tree holds
    each BatchNorm folded to (scale, bias); it goes into conv{i}_BN as
    weight = scale, bias = bias, running mean 0 and running var 1 - eps,
    so that the port's fold, weight / sqrt(var + eps), gives the scale back
    (1 - eps + eps rounds to 1 in float32)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for i in range(1, 7):
        sd[f"conv{i}.weight"] = _t(np.transpose(tree[f"conv{i}"]["kernel"], (3, 2, 0, 1)))
        sd[f"conv{i}.bias"] = _t(tree[f"conv{i}"]["bias"])
        scale = np.asarray(tree[f"bn{i}_scale"], np.float32)
        sd[f"conv{i}_BN.weight"] = _t(scale)
        sd[f"conv{i}_BN.bias"] = _t(tree[f"bn{i}_bias"])
        sd[f"conv{i}_BN.running_mean"] = torch.zeros(scale.shape)
        sd[f"conv{i}_BN.running_var"] = torch.full(scale.shape, 1.0 - bn_eps)
        sd[f"conv{i}_BN.num_batches_tracked"] = torch.tensor(0)
    _linear(sd, "classifier", tree["classifier"])
    return sd


def from_jax_speaker_encoder(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX LSTMSpeakerEncoder params -> the port's state_dict (the
    reference's layers.{i}.lstm / layers.{i}.linear keys)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for i in range(_count(tree, "lstm")):
        b, p = f"layers.{i}", tree[f"lstm_{i}"]
        sd[f"{b}.lstm.weight_ih_l0"] = _t(np.asarray(p["w_ih"]).T)
        sd[f"{b}.lstm.weight_hh_l0"] = _t(np.asarray(p["w_hh"]).T)
        sd[f"{b}.lstm.bias_ih_l0"] = _t(p["b_ih"])
        sd[f"{b}.lstm.bias_hh_l0"] = _t(p["b_hh"])
        sd[f"{b}.linear.weight"] = _t(np.asarray(tree[f"proj_{i}"]).T)
    return sd


def _batch_norm(sd: dict, name: str, p: Mapping, eps: float = 1e-5) -> None:
    """A JAX folded BatchNorm (scale, bias) as a torch BatchNorm in eval mode:
    running mean 0 and running var 1 - eps, so that its fold, weight /
    sqrt(var + eps), gives the scale back."""
    scale = np.asarray(p["scale"], np.float32)
    sd[f"{name}.weight"] = _t(scale)
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = torch.zeros(scale.shape)
    sd[f"{name}.running_var"] = torch.full(scale.shape, 1.0 - eps)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _conv2d(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def from_jax_med(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX MelspecDiscriminator params {convs_i, bn{i}_scale, bn{i}_bias,
    postnet} -> the port's state_dict (`_convs.{i}.0` conv, `_convs.{i}.1`
    BatchNorm2d in eval mode, `_postnet`)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for i in range(_count(tree, "convs")):
        _conv2d(sd, f"_convs.{i}.0", tree[f"convs_{i}"])
        _batch_norm(sd, f"_convs.{i}.1", {"scale": tree[f"bn{i}_scale"],
                                           "bias": tree[f"bn{i}_bias"]})
    _conv2d(sd, "_postnet", tree["postnet"])
    return sd


def from_jax_resnet_speaker(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ResNetSpeakerEncoder params -> the port's state_dict (the
    reference's conv1 / bn1 / layer{i}.{j} / attention / fc keys)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    _conv2d(sd, "conv1", tree["conv1"])
    _batch_norm(sd, "bn1", tree["bn1"])
    for key in sorted(k for k in tree if re.fullmatch(r"layer\d+_\d+", k)):
        li, bi = key[len("layer"):].split("_")
        b, p = f"layer{li}.{bi}", tree[key]
        _conv2d(sd, f"{b}.conv1", p["conv1"])
        _batch_norm(sd, f"{b}.bn1", p["bn1"])
        _conv2d(sd, f"{b}.conv2", p["conv2"])
        _batch_norm(sd, f"{b}.bn2", p["bn2"])
        _linear(sd, f"{b}.se.fc.0", p["se_fc1"])
        _linear(sd, f"{b}.se.fc.2", p["se_fc2"])
        if "ds_conv" in p:
            _conv2d(sd, f"{b}.downsample.0", p["ds_conv"])
            _batch_norm(sd, f"{b}.downsample.1", p["ds_bn"])
    _conv1d(sd, "attention.0", tree["att_conv1"])
    _batch_norm(sd, "attention.2", tree["att_bn"])
    _conv1d(sd, "attention.3", tree["att_conv2"])
    _linear(sd, "fc", tree["fc"])
    return sd


def _silero_conv(sd: dict, name: str, w, b) -> None:
    sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(w), _t(b)


def _silero_block(sd: dict, name: str, p: Mapping) -> None:
    """dw_w [C, 5] -> (C, 1, 5); pw_w / proj_w [O, I] -> (O, I, 1)."""
    _silero_conv(sd, f"{name}.dw_conv", np.asarray(p["dw_w"])[:, None, :], p["dw_b"])
    _silero_conv(sd, f"{name}.pw_conv", np.asarray(p["pw_w"])[:, :, None], p["pw_b"])
    if "proj_w" in p:
        _silero_conv(sd, f"{name}.proj", np.asarray(p["proj_w"])[:, :, None], p["proj_b"])


def _silero_conv_bn(sd: dict, name: str, p: Mapping) -> None:
    _silero_conv(sd, f"{name}.conv", np.asarray(p["w"])[:, :, None], p["b"])
    sd[f"{name}.bn_scale"], sd[f"{name}.bn_bias"] = _t(p["bn_scale"]), _t(p["bn_bias"])


def from_jax_silero_vad(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's silero tree (models/silero_vad.py::load_silero_vad:
    BatchNorms folded, the LSTM's two biases summed into `b`) -> the port's
    SileroVAD state_dict; the summed bias goes to bias_ih, bias_hh is 0."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    sd["stft_basis"] = _t(params["stft_basis"])
    sd["an_filter"] = _t(params["an_filter"])
    _silero_block(sd, "first", params["first"])
    for i, st in enumerate(params["enc"]):
        _silero_conv_bn(sd, f"encoder.{i}.down", st)
        _silero_block(sd, f"encoder.{i}.block", st["block"])
    _silero_conv_bn(sd, "enc_post", params["enc_post"])
    for layer, p in enumerate(params["lstm"]):
        sd[f"rnn.weight_ih_l{layer}"] = _t(p["w_ih"])
        sd[f"rnn.weight_hh_l{layer}"] = _t(p["w_hh"])
        sd[f"rnn.bias_ih_l{layer}"] = _t(p["b"])
        sd[f"rnn.bias_hh_l{layer}"] = torch.zeros(len(p["b"]))
    sd["decoder.weight"] = _t(np.asarray(params["dec_w"])[:, :, None])
    sd["decoder.bias"] = _t(params["dec_b"])
    return sd


def from_jax_opt_state(tree: Mapping, params_to_sd) -> dict:
    """A JAX optimizer state (`serialization.to_state_dict` of the opt_state
    in a `.ckpt`) -> the port's optimizer entry: a torch AdamW
    `state_dict()` ({"state": {i: {step, exp_avg, exp_avg_sq}},
    "param_groups": [{"lr", "params"}]}) with "param_names", the name of
    each index, plus, for the generator's MultiSteps, "acc" (the running mean
    of the accumulated gradients, by name) and "mini_step".

    G's state is optax.MultiSteps(inject_hyperparams(adamw)): {mini_step,
    gradient_step, inner_opt_state, acc_grads, skip_state}; D's is
    inject_hyperparams(adamw): {count, hyperparams, hyperparams_states,
    inner_state}, whose inner_state "0" is scale_by_adam's {count, mu, nu}.
    `params_to_sd` (`from_jax_trn_params` or `from_jax_disc_params`) maps the
    moment and accumulator trees as it maps the parameters: every leaf
    mapping is a transpose or a reshape, so the carry is exact, and indices
    are matched by parameter name."""
    multi = "acc_grads" in tree
    inner = tree["inner_opt_state"] if multi else tree
    adam = inner["inner_state"]["0"]
    mu, nu = params_to_sd(adam["mu"]), params_to_sd(adam["nu"])
    names = list(mu)
    step = torch.tensor(float(np.asarray(adam["count"])))
    out = {
        "state": {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in enumerate(names)},
        "param_groups": [{"lr": float(np.asarray(inner["hyperparams"]["learning_rate"])),
                          "params": list(range(len(names)))}],
        "param_names": names,
    }
    if multi:
        out["acc"] = params_to_sd(tree["acc_grads"])
        out["mini_step"] = int(np.asarray(tree["mini_step"]))
    return out


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


def torch_load_weights(path: str):
    """torch.load(weights_only=True) on the CPU: tensors, numbers, strings
    and plain containers load; a file that pickles other objects is refused
    with an error that names weights_only (unpickling runs arbitrary code)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} holds pickled objects besides tensors and plain containers: it "
            f"does not load with torch.load(weights_only=True), and the port loads "
            f"nothing else") from e


def load_generator(path: str) -> "OrderedDict[str, torch.Tensor]":
    """The generator's state_dict of a checkpoint: `model_g` of a reference
    or port `.pth`/`.pt`, or of a JAX `.ckpt` converted."""
    if path.endswith((".pth", ".pt")):
        return torch_load_weights(path)["model_g"]
    return from_jax_generator(load_jax_ckpt(path)["model_g"])


def load_tolerant(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> list[str]:
    """Copy the model's keys present in `sd` (shapes must match); keys the
    model has and `sd` lacks keep their current values, as the reference
    loaders do (svc_inference.py:61-74). Returns the missing keys. A
    weight-norm pair of `sd` fills a folded module's `weight`, and a folded
    `sd` folds the model's weight norm first (nn/conv.py::fold_weight_norm)."""
    from ..nn.conv import fold_weight_norm

    sd = {k.removeprefix("module."): v for k, v in sd.items()}  # DDP-saved keys
    own = model.state_dict()
    if any(k.endswith("weight_g") and k[:-2] in sd for k in own):
        model.load_state_dict(fold_weight_norm(own))
        own = model.state_dict()
    missing = []
    with torch.no_grad():
        for k, v in own.items():
            src = sd.get(k)
            if src is None and f"{k}_g" in sd and f"{k}_v" in sd:
                pair = {f"weight_{x}": torch.as_tensor(sd[f"{k}_{x}"]) for x in "gv"}
                src = fold_weight_norm(pair)["weight"]
            if src is None:
                missing.append(k)
                continue
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(src.shape)} "
                                 f"vs model {tuple(v.shape)}")
            v.copy_(torch.as_tensor(src))
    return missing
