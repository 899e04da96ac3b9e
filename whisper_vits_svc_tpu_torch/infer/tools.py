"""Model merge / average and speaker mixing (JAX whisper_vits_svc_tpu/
infer/tools.py; reference svc_merge.py:18-58 and svc_eva.py:6-20).

A model is read from a JAX `.ckpt` or a reference `.pth` as its generator's
state_dict (models/convert.py::load_generator) and written as the
reference `.pth` layout {"model_g": state_dict}, which
infer/pipeline.py::load_svc_model reads. The arithmetic is the JAX
package's, in float32 numpy key by key, so the merged parameters equal its
merge of the same inputs.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..models.convert import load_generator


def _save(state: dict, out_path: str) -> "OrderedDict[str, torch.Tensor]":
    sd = OrderedDict((k, torch.from_numpy(np.ascontiguousarray(v))) for k, v in state.items())
    torch.save({"model_g": sd}, out_path)
    return sd


def _numpy(path: str) -> dict:
    return {k: v.numpy() for k, v in load_generator(path).items()}


def merge_model(path_a: str, path_b: str, out_path: str,
                ratio: float = 0.5) -> "OrderedDict[str, torch.Tensor]":
    """model_out = a * ratio + b * (1 - ratio), key by key (svc_merge.py:33-39)."""
    a, b = _numpy(path_a), _numpy(path_b)
    return _save({k: a[k] * ratio + b[k] * (1.0 - ratio) for k in a}, out_path)


def average_model(paths: list[str], out_path: str) -> "OrderedDict[str, torch.Tensor]":
    """N-way average, key by key (svc_merge.py:18-31)."""
    states = [_numpy(p) for p in paths]
    return _save({k: np.mean([s[k] for s in states], axis=0) for k in states[0]}, out_path)


def mix_speakers(spk_paths: list[str], weights: list[float],
                 out_path: str | None = None) -> np.ndarray:
    """eva.spk = sum(w_i * spk_i) (svc_eva.py:6-20)."""
    assert len(spk_paths) == len(weights)
    mixed = sum(w * np.load(p) for p, w in zip(spk_paths, weights))
    mixed = np.asarray(mixed, np.float32)
    if out_path:
        np.save(out_path, mixed, allow_pickle=False)
    return mixed
