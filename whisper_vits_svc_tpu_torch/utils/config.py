"""Config tree: a dot-access dict, loaded from the repo's YAML configs.

PyYAML is imported only inside `load_config`, so code that builds a config
from a dict (`config_from_dict`, `BASE_MODEL_CONFIG`) runs without it.
"""

from __future__ import annotations

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
    import yaml

    with open(path, "r") as f:
        return Config._wrap(yaml.safe_load(f))


def config_from_dict(d: Mapping) -> Config:
    """A new Config tree (dicts and lists rebuilt, so `d` is not aliased)."""
    return Config._wrap(d)


# The data/vits/gen sections of configs/base.yaml, for callers that must not
# depend on PyYAML (chip_smoke.py). tests/test_torch_pipeline.py holds this
# copy equal to the YAML file.
BASE_MODEL_CONFIG = {
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
}
