"""Training observability: JSONL metrics, and TensorBoard scalars, audio and
images where `torch.utils.tensorboard` imports (JAX
whisper_vits_svc_tpu/train/writer.py; reference vits_extend/writer.py:12-35).

`metrics.jsonl` gets one record per logged step ({"step", "time", metric...},
with the throughput counters steps_per_s and audio_seconds_per_s) and one per
validation ({"step", "validation_mel_loss"}). Without tensorboard (or without
matplotlib for the image panels) the writer keeps the JSONL records only.
"""

from __future__ import annotations

import json
import os
import time


class TrainWriter:
    def __init__(self, log_dir: str, sample_rate: int = 32000):
        os.makedirs(log_dir, exist_ok=True)
        self.sample_rate = sample_rate
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except Exception:
            self.tb = None

    def log_training(self, metrics: dict, step: int):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(f"train/{k}", v, step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def log_validation(self, mel_loss: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar("validation/mel_loss", float(mel_loss), step)
        self.jsonl.write(json.dumps({"step": step, "validation_mel_loss": float(mel_loss)})
                         + "\n")
        self.jsonl.flush()

    def log_audio(self, tag: str, audio, step: int):
        if self.tb is not None:
            self.tb.add_audio(tag, audio.reshape(1, -1), step, self.sample_rate)

    def log_fig_audio(self, real, fake, spec_fake, spec_real, idx: int, step: int):
        """Fake/real audio and waveform/spectrogram panels (reference
        vits_extend/writer.py:25-35), for utterance 0 only."""
        if self.tb is None or idx != 0:
            return
        try:
            from .plotting import (
                amplitude_to_db, plot_spectrogram_to_numpy, plot_waveform_to_numpy,
            )

            images = {
                f"spec_fake/{step}": plot_spectrogram_to_numpy(amplitude_to_db(spec_fake)),
                f"spec_real/{step}": plot_spectrogram_to_numpy(amplitude_to_db(spec_real)),
                f"wave_fake/{step}": plot_waveform_to_numpy(fake),
                f"wave_real/{step}": plot_waveform_to_numpy(real),
            }
        except ImportError:  # no matplotlib: audio only
            images = {}
        for tag, image in images.items():
            self.tb.add_image(tag, image, step, dataformats="HWC")
        self.tb.add_audio(f"fake/{step}", fake.reshape(1, -1), step, self.sample_rate)
        self.tb.add_audio(f"real/{step}", real.reshape(1, -1), step, self.sample_rate)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
