"""A copy of the benchmark's folder with the test-only narrow configuration
(`micro.json`, hop 8) and one cell of each driver at that width, for runs on
the CPU."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
MICRO_CELLS = {
    "micro-song": {"config": "micro", "driver": "song",
                   "traffic": {"songs": 3, "min_frames": 30, "max_frames": 70, "out_chunk": 20,
                               "hop_frame": 2, "chunk_batch": 1, "noise_scale": 1.0},
                   "limits": {"wave_max_abs": 1e-5}},
    "micro-live": {"config": "micro", "driver": "live",
                   "traffic": {"stream_blocks": 4, "block_frames": 10, "context_frames": 5,
                               "noise_scale": 1.0, "warm_pushes": 2},
                   "limits": {"block_max_abs": 1e-5}},
    "micro-train": {"config": "micro", "driver": "train",
                    "traffic": {"utterances": 16, "min_frames": 10, "max_frames": 30,
                                "bucket_frames": 10, "checked_steps": 3},
                    "limits": {"loss_rel_gap": 1e-4, "grad1_median_gap": 1e-3,
                               "change_median_gap": 1e-2}},
}


def micro_model() -> dict:
    return json.loads((HERE / "micro.json").read_text())["model"]


@pytest.fixture
def micro_root(tmp_path) -> Path:
    """<tmp>/benchmark: the folder as committed plus configs/micro.json; the
    micro cells are added by `add_cell`."""
    root = tmp_path / "benchmark"
    shutil.copytree(HERE.parent, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(HERE / "micro.json", root / "configs" / "micro.json")
    bench = {"per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def add_cell(root: Path, name: str, spec: dict | None = None) -> None:
    (root / "workloads" / f"{name}.json").write_text(json.dumps(spec or MICRO_CELLS[name]))
