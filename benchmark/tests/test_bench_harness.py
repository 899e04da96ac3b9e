"""The harness: the import guard, the result line's schema, a new cell of an
existing driver found from one new file, the faults each cell can have
coming out as `correct` false, and the refusals of run.py. The runs here go
through `run_cell` on the CPU at micro widths, skipping run.py's look for a
card; the card test holds the control (the reference in TF32) to failing."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.guard import loaded_forbidden
from benchmark.harness import RESULT_KEYS, run_cell, schema_errors
from benchmark.tests.conftest import MICRO_CELLS, add_cell

CHECKOUT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977  # a seed over 32 signed bits


@pytest.mark.parametrize("name, bad", [
    ("whisper_vits_svc_tpu_torch", False), ("whisper_vits_svc_tpu_torch.ops.snake_cuda", False),
    ("whisper_vits_svc_tpu", True), ("whisper_vits_svc_tpu.models.generator", True),
    ("jax", True), ("jax._src.core", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("jax_like", False), ("torch", False)])
def test_import_guard_compares_top_level_names_whole(name, bad):
    assert loaded_forbidden([name]) == ([name] if bad else [])


@pytest.mark.parametrize("cell", sorted(MICRO_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_micro_run_is_correct_and_well_formed(micro_root, cell, trace):
    add_cell(micro_root, cell)
    result = run_cell(cell, SEED, 0.3, bool(trace), "cpu", root=micro_root)
    assert schema_errors(result) == []
    assert list(result)[: len(RESULT_KEYS)] == list(RESULT_KEYS)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1
    if not trace:
        assert result["metrics"]["setup_s"]["value"] > 0
        assert len(result["metrics"]) == 2
    json.dumps(result)


def test_schema_errors_are_found():
    good = {"correct": True, "attempted": 1, "failed": 0,
            "metrics": {"x": {"value": 1.0, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1},
            "checks": {}}
    assert schema_errors(good) == []
    assert schema_errors({k: v for k, v in good.items() if k != "device"}) == ["missing device"]
    bad = dict(good, metrics={"x": {"value": "1"}})
    assert schema_errors(bad) == ["metric x is not {value, unit}"]
    moved = {k: good[k] for k in ("checks", "correct", "attempted", "failed", "metrics", "device")}
    assert schema_errors(moved) == ["checks is not the last key"]


def test_a_new_cell_is_one_new_file(micro_root):
    """A song cell of clips: the driver, the configuration and every reader
    exist, so the cell is the workload file alone."""
    before = sorted(p.relative_to(micro_root) for p in micro_root.rglob("*") if p.is_file())
    spec = dict(MICRO_CELLS["micro-song"],
                traffic=dict(MICRO_CELLS["micro-song"]["traffic"], songs=2, min_frames=8,
                             max_frames=16))
    add_cell(micro_root, "micro-clips", spec)
    after = sorted(p.relative_to(micro_root) for p in micro_root.rglob("*") if p.is_file())
    assert sorted(set(after) - set(before)) == [Path("workloads/micro-clips.json")]
    result = run_cell("micro-clips", SEED, 0.3, False, "cpu", root=micro_root)
    assert result["correct"] is True
    assert result["metrics"]["song_audio_s_per_s"]["value"] > 0


def _altered(fn):
    def wrapper(*args, **kwargs):
        out = np.array(fn(*args, **kwargs))
        out[len(out) // 2] += 1e-3
        return out
    return wrapper


def test_fault_song_answer_altered(micro_root, monkeypatch):
    from whisper_vits_svc_tpu_torch.infer import pipeline

    add_cell(micro_root, "micro-song")
    monkeypatch.setattr(pipeline, "svc_infer", _altered(pipeline.svc_infer))
    assert run_cell("micro-song", SEED, 0.3, False, "cpu", root=micro_root)["correct"] is False


def test_fault_live_block_altered(micro_root, monkeypatch):
    from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc

    add_cell(micro_root, "micro-live")
    monkeypatch.setattr(StreamingSvc, "push", _altered(StreamingSvc.push))
    assert run_cell("micro-live", SEED, 0.3, False, "cpu", root=micro_root)["correct"] is False


def test_fault_train_state_unchanged(micro_root, monkeypatch):
    from whisper_vits_svc_tpu_torch.train import step

    add_cell(micro_root, "micro-train")
    monkeypatch.setattr(step.TrainState, "apply_gradients", lambda self, grads: False)
    result = run_cell("micro-train", SEED, 0.3, False, "cpu", root=micro_root)
    assert result["correct"] is False
    assert result["checks"]["change_median_gap"]["value"] == pytest.approx(1.0)


def test_fault_train_half_batch(micro_root, monkeypatch):
    from whisper_vits_svc_tpu_torch.train import step

    add_cell(micro_root, "micro-train")
    to_device = step._to_device

    def half(batch, device):
        b = torch.as_tensor(batch["ppg"]).shape[0] // 2
        return to_device({k: torch.as_tensor(v)[:b] for k, v in batch.items()}, device)

    monkeypatch.setattr(step, "_to_device", half)
    result = run_cell("micro-train", SEED, 0.3, False, "cpu", root=micro_root)
    assert result["correct"] is False
    assert result["checks"]["loss_rel_gap"]["value"] > 1e-3


def test_fault_train_after_warm_up(micro_root, monkeypatch):
    """A fault that switches on only for a batch shape the step has seen
    before, as a graph captured on a repeated shape would, is caught: the
    checked steps run after every shape was warmed."""
    from whisper_vits_svc_tpu_torch.train import step

    spec = json.loads(json.dumps(MICRO_CELLS["micro-train"]))
    spec["traffic"]["max_frames"] = 40  # batches of 20, 40, 30, 20, 30 frames: the checked
    add_cell(micro_root, "micro-train", spec)  # steps' three shapes differ
    make = step.make_train_step

    def make_faulty(hp, g_state, d_state):
        real, seen = make(hp, g_state, d_state), set()

        def train_step(batch, generator=None):
            shape = tuple(batch["ppg"].shape)
            if shape in seen:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            seen.add(shape)
            return real(batch, generator)

        return train_step

    monkeypatch.setattr(step, "make_train_step", make_faulty)
    result = run_cell("micro-train", SEED, 0.3, False, "cpu", root=micro_root)
    assert result["correct"] is False
    assert result["checks"]["loss_rel_gap"]["value"] > 1e-3


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "svc5-live",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=CHECKOUT, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ has no program."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark.harness import run_cell; "
            f"print(run_cell('svc5-live', {SEED}, 1, False, 'cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "whisper_vits_svc_tpu_torch" in proc.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", ["micro-song", "micro-live", "micro-train"])
def test_control_fails_on_card(micro_root, cell):
    """The reference in TF32 put in the program's place reads at least ten
    times what the program reads, at micro widths on the card (the cells'
    own sizes are read by benchmark/readings.py)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from benchmark.harness import driver_class, load_cell

    add_cell(micro_root, cell)
    c = load_cell(cell, micro_root)
    drv = driver_class(c)(c, SEED, "cuda")
    drv.setup()
    records = [drv.unit() for _ in range(3)]
    drv.release()
    prog = {n: v for n, v, _ in drv.check(records)}
    ctrl = {n: v for n, v, _ in drv.check(records, "control")}
    assert any(ctrl[n] >= 10 * max(prog[n], 1e-9) for n in prog), (prog, ctrl)
