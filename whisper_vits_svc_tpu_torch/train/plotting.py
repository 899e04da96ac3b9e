"""Waveform and spectrogram images for the TensorBoard validation panels
(JAX whisper_vits_svc_tpu/train/plotting.py; reference
vits_extend/plotting.py:19-49). matplotlib is imported inside each function,
on the Agg backend; images are HWC uint8 arrays.
"""

from __future__ import annotations

import numpy as np


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape(h, w, 4)[..., :3].copy()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_waveform_to_numpy(waveform: np.ndarray) -> np.ndarray:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(waveform, linewidth=0.5)
    ax.set_xlabel("samples")
    ax.set_ylabel("amplitude")
    fig.tight_layout()
    out = _fig_to_array(fig)
    plt.close(fig)
    return out


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """spectrogram: [bins, frames] (dB or log scale)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("frames")
    ax.set_ylabel("bins")
    fig.tight_layout()
    out = _fig_to_array(fig)
    plt.close(fig)
    return out


def amplitude_to_db(mag: np.ndarray, top_db: float = 80.0) -> np.ndarray:
    """librosa.amplitude_to_db(ref=np.max) (reference writer.py:27-28)."""
    db = 20.0 * np.log10(np.maximum(mag, 1e-10) / max(mag.max(), 1e-10))
    return np.maximum(db, -top_db)
