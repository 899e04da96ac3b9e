"""The port's training writer and plot panels, as tests/test_observability.py
holds the JAX package's: the same images and JSONL records, and the JSONL-only
route when torch.utils.tensorboard does not import."""

import json
import os
import sys

import numpy as np

from whisper_vits_svc_tpu.train import plotting as jplotting
from whisper_vits_svc_tpu_torch.train.plotting import (
    amplitude_to_db, plot_spectrogram_to_numpy, plot_waveform_to_numpy,
)
from whisper_vits_svc_tpu_torch.train.writer import TrainWriter


def test_plotting_arrays(rng):
    wav = rng.standard_normal(1000).astype(np.float32)
    img = plot_waveform_to_numpy(wav)
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    spec = np.abs(rng.standard_normal((100, 50))).astype(np.float32)
    img2 = plot_spectrogram_to_numpy(amplitude_to_db(spec))
    assert img2.ndim == 3
    db = amplitude_to_db(spec)
    assert db.max() <= 0.0 and db.min() >= -80.0
    np.testing.assert_array_equal(db, jplotting.amplitude_to_db(spec))
    np.testing.assert_array_equal(img, jplotting.plot_waveform_to_numpy(wav))


def _log_everything(w, rng):
    w.log_training({"loss_g": 1.0, "loss_d": 2.0}, step=10)
    w.log_validation(0.5, step=10)
    w.log_audio("fake/0", rng.standard_normal(100).astype(np.float32), 10)
    spec = np.abs(rng.standard_normal((64, 20))).astype(np.float32)
    w.log_fig_audio(rng.standard_normal(500).astype(np.float32),
                    rng.standard_normal(500).astype(np.float32), spec, spec, 0, 10)
    w.close()


def _records(log_dir):
    return [json.loads(line) for line in
            open(os.path.join(log_dir, "metrics.jsonl")).read().strip().splitlines()]


def test_writer_logs(tmp_path, rng):
    w = TrainWriter(str(tmp_path), 32000)
    assert w.tb is not None
    _log_everything(w, rng)
    recs = _records(tmp_path)
    assert len(recs) == 2
    assert recs[0]["step"] == 10 and recs[0]["loss_g"] == 1.0 and recs[0]["loss_d"] == 2.0
    assert recs[1] == {"step": 10, "validation_mel_loss": 0.5}
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))


def test_writer_jsonl_only_without_tensorboard(tmp_path, rng, monkeypatch):
    """With torch.utils.tensorboard failing to import, every call still
    works and the JSONL records are the same."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = TrainWriter(str(tmp_path), 32000)
    assert w.tb is None
    _log_everything(w, rng)
    recs = _records(tmp_path)
    assert [sorted(r) for r in recs] == [["loss_d", "loss_g", "step", "time"],
                                         ["step", "validation_mel_loss"]]
    assert os.listdir(tmp_path) == ["metrics.jsonl"]
