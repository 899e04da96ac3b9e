"""Post-synthesis VAD hard-mute filter (JAX whisper_vits_svc_tpu/infer/post.py).

The reference runs the TorchScript silero_vad.jit over the 16 kHz input wav,
builds a 0/1 speech mask from `get_speech_timestamps` (threshold 0.2,
vad/utils.py:164), repeats it x2 to 32 kHz and multiplies it into the SVC
output (svc_inference_post.py:31-51): a hard mute of non-speech.

The probabilities come from the port's silero network on its device
(`models/silero_vad.py`) when a model is given, else from a per-window RMS
energy normalized to its 95th percentile, as the JAX package falls back;
the trigger logic (window 512 at 16 kHz, min speech 250 ms, min silence
100 ms, 30 ms speech padding, hysteresis at threshold - 0.15) is the JAX
package's numpy, line for line.
"""

from __future__ import annotations

import numpy as np


def get_speech_timestamps(
    audio: np.ndarray,
    threshold: float = 0.2,
    sampling_rate: int = 16000,
    min_speech_duration_ms: int = 250,
    min_silence_duration_ms: int = 100,
    window_size_samples: int = 512,
    speech_pad_ms: int = 30,
    vad_model=None,
) -> list[dict]:
    """silero-compatible speech segments [{'start': s, 'end': e}, ...] (samples).

    `vad_model` (a models.silero_vad.SileroVAD, e.g. from load_silero_vad)
    selects the silero network, run on its device; otherwise the
    probability is a per-window RMS energy normalized to the 95th
    percentile. Both use silero's hysteresis at (threshold, threshold -
    0.15) (vad/utils.py:281).
    """
    n = len(audio)
    n_win = n // window_size_samples
    if n_win == 0:
        return []
    if vad_model is not None:
        from ..models.silero_vad import silero_speech_probs

        prob = silero_speech_probs(vad_model, audio, window_size_samples)[:n_win]
    else:
        frames = audio[: n_win * window_size_samples].reshape(
            n_win, window_size_samples)
        rms = np.sqrt(np.mean(np.square(frames), axis=1))
        ref = np.percentile(rms, 95) + 1e-9
        prob = np.clip(rms / ref, 0.0, 1.0)

    neg_threshold = max(threshold - 0.15, 0.01)
    min_speech = sampling_rate * min_speech_duration_ms // 1000
    min_silence = sampling_rate * min_silence_duration_ms // 1000
    pad = sampling_rate * speech_pad_ms // 1000

    speeches = []
    triggered = False
    cur = {}
    tmp_end = 0
    for i, p in enumerate(prob):
        s = i * window_size_samples
        if p >= threshold and not triggered:
            triggered = True
            cur = {"start": s}
            tmp_end = 0
        elif triggered and p < neg_threshold:
            if not tmp_end:
                tmp_end = s + window_size_samples
            if s + window_size_samples - tmp_end >= min_silence:
                cur["end"] = tmp_end
                if cur["end"] - cur["start"] > min_speech:
                    speeches.append(cur)
                triggered = False
                cur, tmp_end = {}, 0
        elif triggered and p >= threshold:
            tmp_end = 0
    if triggered:
        cur["end"] = n
        if cur["end"] - cur["start"] > min_speech:
            speeches.append(cur)

    for i, sp in enumerate(speeches):
        sp["start"] = int(max(0, sp["start"] - pad))
        sp["end"] = int(min(n, sp["end"] + pad))
    return speeches


def apply_vad_mask(
    svc_audio_32k: np.ndarray, reference_audio_16k: np.ndarray,
    threshold: float = 0.2,
    vad_model=None,
) -> np.ndarray:
    """Hard-mute non-speech in the 32 kHz SVC output using the 16 kHz input's
    speech mask (svc_inference_post.py:31-51)."""
    tags = get_speech_timestamps(
        reference_audio_16k, threshold=threshold, vad_model=vad_model)
    mask16 = np.zeros(len(reference_audio_16k), np.float32)
    for seg in tags:
        mask16[seg["start"] : seg["end"]] = 1.0
    mask32 = np.repeat(mask16, 2)
    n = min(len(mask32), len(svc_audio_32k))
    out = svc_audio_32k.copy()
    out[:n] = out[:n] * mask32[:n]
    out[n:] = 0.0
    return out
