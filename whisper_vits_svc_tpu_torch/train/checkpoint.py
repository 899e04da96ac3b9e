"""Checkpoint save, restore and export (JAX whisper_vits_svc_tpu/train/checkpoint.py;
reference vits_extend/train.py:113-133, :265-309, svc_export.py:48-57).

A trainer checkpoint is the reference's `.pth` layout, one `torch.save` dict
{model_g, model_d, optim_g, optim_d, step, epoch, hp_str}: the models'
state_dicts under the reference's key names, and each optimizer's torch
AdamW `state_dict()` with "param_names" (the parameter name of each index,
so a reader maps by name); G's entry also holds the MultiSteps accumulator
"acc" (by name) and "mini_step". Writes go to `path + ".tmp"` and then
`os.replace`. Everything loads with `torch.load(weights_only=True)`; the JAX
package reads the layout too (its `load_torch_pretrain` and its `.pth`
inference route). A JAX `.ckpt` (flax msgpack) loads through
models/convert.py, its optax state included (`from_jax_opt_state`).

Checkpoints are named `{name}_{epoch:04d}.pth`; `latest_checkpoint` and
`clean_checkpoints` go by mtime. `export_inference` keeps {model_g} without
the posterior, the speaker classifier and the speaker embedding.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Mapping

import torch

from ..models.convert import (
    from_jax_disc_params, from_jax_generator, from_jax_opt_state, from_jax_trn_params,
    load_jax_ckpt, torch_load_weights,
)
from .step import TrainState

EXPORT_DROPS = ("enc_q.", "speaker_classifier.", "emb_g.")


def _optimizer_entry(state: TrainState) -> dict:
    entry = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    entry["param_names"] = names
    if state.acc is not None:
        entry["acc"] = dict(zip(names, state.acc))
        entry["mini_step"] = state.mini_step
    return entry


def save(path: str, g_state: TrainState, d_state: TrainState, step: int, epoch: int,
         hp_str: str = "") -> None:
    payload = {
        "model_g": g_state.model.state_dict(),
        "model_d": d_state.model.state_dict(),
        "optim_g": _optimizer_entry(g_state),
        "optim_d": _optimizer_entry(d_state),
        "step": int(step),
        "epoch": int(epoch),
        "hp_str": hp_str,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str) -> dict:
    """A checkpoint as the port's payload: a `.pth`/`.pt` as saved, a JAX
    `.ckpt` converted (parameters, optimizer states, step, epoch, and its
    hp_raw as hp_str)."""
    if path.endswith((".pth", ".pt")):
        return torch_load_weights(path)
    tree = load_jax_ckpt(path)
    return {
        "model_g": from_jax_generator(tree["model_g"]),
        "model_d": from_jax_disc_params(tree["model_d"]) if tree.get("model_d") else {},
        "optim_g": (from_jax_opt_state(tree["optim_g"], from_jax_trn_params)
                    if tree.get("optim_g") is not None else None),
        "optim_d": (from_jax_opt_state(tree["optim_d"], from_jax_disc_params)
                    if tree.get("optim_d") is not None else None),
        "step": int(tree.get("step", 0)),
        "epoch": int(tree.get("epoch", 1)),
        "hp_str": tree.get("hp_raw", ""),
    }


def merge_tolerant(init: Mapping[str, torch.Tensor], saved: Mapping[str, torch.Tensor],
                   ) -> "OrderedDict[str, torch.Tensor]":
    """Key-by-key restore keeping the init value of every key the checkpoint
    lacks (reference load_model, vits_extend/train.py:43-59); shapes must
    match."""
    out = OrderedDict()
    for k, v in init.items():
        src = saved.get(k, saved.get(f"module.{k}"))  # DDP-saved keys carry "module."
        if src is None:
            print(f"{k} is not in the checkpoint")
            out[k] = v
            continue
        if tuple(src.shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(src.shape)} "
                             f"vs model {tuple(v.shape)}")
        out[k] = src
    return out


def _load_model(model: torch.nn.Module, saved: Mapping[str, torch.Tensor]) -> None:
    model.load_state_dict(merge_tolerant(model.state_dict(), saved))


def _load_optimizer(state: TrainState, saved: dict) -> None:
    """The saved AdamW moments and step per parameter, matched by name, the
    saved learning rate, and G's accumulator."""
    names = [n for n, _ in state.model.named_parameters()]
    pos = {n: i for i, n in enumerate(saved.get("param_names", names))}
    group = {k: v for k, v in saved["param_groups"][0].items() if k != "params"}
    missing = [n for n in names if pos.get(n) not in saved["state"]]
    for n in missing:
        print(f"optimizer state of {n} is not in the checkpoint")
    state.optimizer.load_state_dict({
        "state": {i: saved["state"][pos[n]] for i, n in enumerate(names) if n not in missing},
        "param_groups": [{**state.optimizer.param_groups[0], **group,
                          "params": list(range(len(names)))}],
    })
    if state.acc is not None and saved.get("acc") is not None:
        with torch.no_grad():
            for n, a in zip(names, state.acc):
                if n in saved["acc"]:
                    a.copy_(saved["acc"][n])
        state.mini_step = int(saved["mini_step"])


def restore_states(g_state: TrainState, d_state: TrainState, payload: dict):
    """Models, optimizers (where the payload has them) and counters, in
    place. Returns (g_state, d_state, step, epoch)."""
    for state, model_key, optim_key in ((g_state, "model_g", "optim_g"),
                                        (d_state, "model_d", "optim_d")):
        _load_model(state.model, payload[model_key])
        if payload.get(optim_key) is not None:
            _load_optimizer(state, payload[optim_key])
    return g_state, d_state, int(payload.get("step", 0)), int(payload.get("epoch", 1))


def warm_start(g_state: TrainState, d_state: TrainState, payload: dict):
    """Model weights only, optimizers untouched (train.py:113-118)."""
    _load_model(g_state.model, payload["model_g"])
    if payload.get("model_d"):
        _load_model(d_state.model, payload["model_d"])
    return g_state, d_state


def export_inference(path: str, g: torch.nn.Module | Mapping[str, torch.Tensor]) -> None:
    """{model_g} for synthesis (svc_export.py:48-57): the posterior, the
    speaker classifier and the speaker embedding are dropped."""
    sd = g.state_dict() if isinstance(g, torch.nn.Module) else g
    torch.save({"model_g": OrderedDict((k, v) for k, v in sd.items()
                                       if not k.startswith(EXPORT_DROPS))}, path)


def load_torch_pretrain(path: str) -> dict:
    """A reference `.pth` (or a bare generator state_dict) as a warm-start
    payload, loaded with weights_only=True."""
    ckpt = torch_load_weights(path)
    return {"model_g": ckpt.get("model_g", ckpt), "model_d": ckpt.get("model_d", {}),
            "optim_g": None, "optim_d": None, "step": int(ckpt.get("step", 0)),
            "epoch": int(ckpt.get("epoch", 1)), "hp_str": ""}


def _checkpoints(pth_dir: str, name: str) -> list[str]:
    if not os.path.isdir(pth_dir):
        return []
    pat = re.compile(rf"{re.escape(name)}_\d+\.pth$")
    return [os.path.join(pth_dir, f) for f in os.listdir(pth_dir) if pat.match(f)]


def latest_checkpoint(pth_dir: str, name: str) -> str | None:
    """Newest `{name}_NNNN.pth` by mtime, or None (the NaN guard's
    auto-resume anchor)."""
    files = _checkpoints(pth_dir, name)
    return max(files, key=os.path.getmtime) if files else None


def clean_checkpoints(pth_dir: str, name: str, keep: int) -> None:
    """mtime-ordered clean-up, 0 = keep all (reference train.py:280-309)."""
    if keep <= 0:
        return
    files = sorted(_checkpoints(pth_dir, name), key=os.path.getmtime)
    for f in files[:-keep]:
        os.remove(f)
        print(f"Free up space by deleting ckpt {f}")
