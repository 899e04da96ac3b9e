"""Config tree: a dot-access dict, loaded from the repo's YAML configs.

PyYAML is imported only inside `load_config` and `dump_config`, and only for
a YAML file, so code that builds a config from a dict (`config_from_dict`,
`BASE_MODEL_CONFIG`), reads a `.json` config or edits one
(`edit_config_file`) runs without it.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class Config(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @staticmethod
    def _wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj


def load_config(path: str) -> Config:
    """The YAML file as a Config; its text is kept under "raw" (stored in
    checkpoints as hp_str, to warn when a resumed run's config differs). A
    `.json` file (JSON is YAML too) reads without PyYAML."""
    with open(path, "r") as f:
        raw = f.read()
    if path.endswith(".json"):
        tree = json.loads(raw)
    else:
        import yaml

        tree = yaml.safe_load(raw)
    cfg = Config._wrap(tree)
    cfg["raw"] = raw
    return cfg


def config_from_dict(d: Mapping) -> Config:
    """A new Config tree (dicts and lists rebuilt, so `d` is not aliased)."""
    return Config._wrap(d)


def _plain(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


def dump_config(cfg: Mapping) -> str:
    """The tree as YAML text in its key order, without "raw"."""
    import yaml

    d = _plain(cfg)
    d.pop("raw", None)
    return yaml.safe_dump(d, sort_keys=False)


def edit_config_file(src: str, dst: str, updates: Mapping[str, Mapping[str, Any]]) -> str:
    """Rewrite `section.key: value` scalars of the 2-level config `src` into
    `dst`, keeping every comment, blank line, quote and the key order (the
    WebUI's train.yaml edit; reference app.py:169-180 does it with ruamel).

    updates: {"train": {"learning_rate": 1e-4, ...}, "log": {...}}. Returns
    the text written. Raises KeyError if a key is not found in its section.
    A `.json` file is loaded, updated and dumped in its own key order (the
    card's machine has no PyYAML, so a config there is JSON)."""
    with open(src, "r") as f:
        raw = f.read()
    if src.endswith(".json"):
        text = _edit_json(src, raw, updates)
    else:
        text = _edit_yaml_lines(src, raw, updates)
    with open(dst, "w") as f:
        f.write(text)
    return text


def _edit_json(src: str, raw: str, updates: Mapping[str, Mapping[str, Any]]) -> str:
    tree = json.loads(raw)
    missing = {s: [k for k in kv if k not in tree.get(s, {})] for s, kv in updates.items()}
    missing = {s: ks for s, ks in missing.items() if ks}
    if missing:
        raise KeyError(f"keys not found in {src}: {missing}")
    for section, kv in updates.items():
        tree[section].update(kv)
    return json.dumps(tree, indent=2) + "\n"


def _edit_yaml_lines(src: str, raw: str, updates: Mapping[str, Mapping[str, Any]]) -> str:
    """The line edit of the JAX package's `edit_config_file`, byte for byte."""
    lines = raw.split("\n")
    pending = {s: dict(kv) for s, kv in updates.items() if kv}
    section = None
    for i, line in enumerate(lines):
        stripped = line.split("#", 1)[0].rstrip()
        if stripped and not line[:1].isspace() and stripped.endswith(":"):
            section = stripped[:-1]
            continue
        if section in pending and line[:1].isspace() and ":" in stripped:
            key = stripped.split(":", 1)[0].strip()
            if key in pending[section]:
                value = pending[section].pop(key)
                if isinstance(value, str):
                    value_s = f'"{value}"'
                elif isinstance(value, bool):
                    value_s = "true" if value else "false"
                else:
                    value_s = repr(value)
                indent = line[: len(line) - len(line.lstrip())]
                comment = ""
                if "#" in line:
                    comment = "  #" + line.split("#", 1)[1]
                lines[i] = f"{indent}{key}: {value_s}{comment}"
                if not pending[section]:
                    del pending[section]
    leftover = {s: list(kv) for s, kv in pending.items()}
    if leftover:
        raise KeyError(f"keys not found in {src}: {leftover}")
    return "\n".join(lines)


# The train/data/vits/gen/mpd/mrd/log sections of configs/base.yaml, for callers
# that must not depend on PyYAML (chip_smoke.py). tests/test_torch_pipeline.py
# holds this copy equal to the YAML file.
BASE_MODEL_CONFIG = {
    "train": {
        "model": "sovits",
        "seed": 1234,
        "epochs": 10000,
        "learning_rate": 5.0e-5,
        "betas": [0.8, 0.99],
        "lr_decay": 0.999875,
        "eps": 1.0e-9,
        "batch_size": 16,
        "accum_step": 2,
        "nan_guard": True,
        "nan_autoresume": False,
        "nan_lr_factor": 0.5,
        "nan_max_restarts": 2,
        "clip_grad_value": None,
        "c_stft": 9,
        "c_mel": 1.0,
        "c_kl": 0.2,
        "pretrain": "",
    },
    "data": {
        "training_files": "files/train.txt",
        "validation_files": "files/valid.txt",
        "segment_size": 8000,
        "max_wav_value": 32768.0,
        "sampling_rate": 32000,
        "filter_length": 1024,
        "hop_length": 320,
        "win_length": 1024,
        "mel_channels": 100,
        "mel_fmin": 50.0,
        "mel_fmax": 16000.0,
    },
    "vits": {
        "ppg_dim": 1280,
        "vec_dim": 256,
        "spk_dim": 256,
        "gin_channels": 256,
        "inter_channels": 192,
        "hidden_channels": 192,
        "filter_channels": 640,
    },
    "gen": {
        "upsample_input": 192,
        "upsample_rates": [5, 4, 4, 2, 2],
        "upsample_kernel_sizes": [15, 8, 8, 4, 4],
        "upsample_initial_channel": 320,
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    },
    "mpd": {
        "periods": [2, 3, 5, 7, 11],
        "kernel_size": 5,
        "stride": 3,
        "lReLU_slope": 0.2,
    },
    "mrd": {
        "resolutions": [[1024, 120, 600], [2048, 240, 1200], [4096, 480, 2400], [512, 50, 240]],
        "lReLU_slope": 0.2,
    },
    "log": {
        "info_interval": 100,
        "eval_interval": 1,
        "save_interval": 5,
        "num_audio": 6,
        "pth_dir": "chkpt",
        "log_dir": "logs",
        "keep_ckpts": 0,
    },
}
