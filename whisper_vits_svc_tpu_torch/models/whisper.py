"""Whisper audio encoder, the PPG content extractor (JAX
whisper_vits_svc_tpu/models/whisper.py; reference whisper/model.py:57-163,
whisper/inference.py:11-62).

Only the encoder exists, with the reference's 24-of-32-layer cut applied at
load. It runs in float32 (TF32 off, `utils/device.py`), attention as two
matmuls and a softmax, as the JAX package computes it. All 15 s windows of
an utterance, the zero-padded tail among them, go through one batched call;
the tail's padded mel frames are left out of the log-mel floor and masked
out of the attention keys.

The log-mel frontend is whisper/audio.py:68-100: hann(400), hop 160,
center=True reflect, power spectrum with the last frame dropped, log10
clamped at 1e-10, per-window max-8 floor, (x + 4) / 4.

Parameter names are the reference's encoder keys without the "encoder."
prefix; `positional_embedding` is recomputed in float32 and not loaded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mel import mel_filterbank
from ..ops.stft import _on, stft_magnitude
from ..utils.device import resolve_device
from .convert import torch_load_weights

SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
WINDOW_SECONDS = 15
WINDOW_SAMPLES = WINDOW_SECONDS * SAMPLE_RATE
PPG_HOP = 320  # samples per PPG frame
MEL_NOISE = 0.1  # sigma of the inference-time mel noise


def log_mel_spectrogram(audio: torch.Tensor,
                        n_samples: torch.Tensor | None = None) -> torch.Tensor:
    """[B, T] 16 kHz audio -> [B, frames, 80] whisper log-mel.

    n_samples [B] marks the real (un-padded) length per row: the per-window
    floor (max - 8) is then taken over real frames only, so a zero-padded
    row gets the floor of its natural-length run."""
    mag2 = stft_magnitude(audio, N_FFT, HOP_LENGTH, N_FFT, center=True) ** 2
    mag2 = mag2[:, :-1, :]  # whisper drops the final STFT frame (audio.py:92)
    mel_w = _on(mag2.device, ("mel", SAMPLE_RATE, N_FFT, N_MELS, 0.0, None),
                lambda: np.ascontiguousarray(mel_filterbank(SAMPLE_RATE, N_FFT, N_MELS).T))
    log_spec = torch.log10((mag2 @ mel_w).clamp_min(1e-10))
    if n_samples is None:
        floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    else:
        frames = torch.arange(log_spec.shape[1], device=log_spec.device)
        valid = (frames[None, :] < (n_samples // HOP_LENGTH)[:, None])[..., None]
        floor = log_spec.masked_fill(~valid, -torch.inf).amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class WhisperAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, _ = x.shape
        q = self.query(x)
        width = q.shape[-1]  # n_state, or a tensor-parallel rank's share of the heads
        hd = width // self.n_head
        scale = hd**-0.25

        def heads(y):
            return y.view(b, t, self.n_head, hd).transpose(1, 2)

        qk = (heads(q) * scale) @ (heads(self.key(x)) * scale).transpose(-1, -2)
        if key_mask is not None:
            # padded keys excluded: real queries attend over exactly the keys
            # of a natural-length run
            qk = qk.masked_fill(~key_mask[:, None, None, :], -1e9)
        out = torch.softmax(qk, dim=-1) @ heads(self.value(x))
        return self.out(out.transpose(1, 2).reshape(b, t, width))


class WhisperBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = WhisperAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-5)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x), key_mask)
        return x + self.mlp(self.mlp_ln(x))


class WhisperEncoder(nn.Module):
    """AudioEncoder with the SVC layer cut applied (large-v2 dims by default)."""

    def __init__(self, n_mels: int = 80, n_ctx: int = 1500, n_state: int = 1280,
                 n_head: int = 20, n_layer: int = 24,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_state = n_state
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv1d(n_mels, n_state, 3, padding=1)
        self.conv2 = nn.Conv1d(n_state, n_state, 3, stride=2, padding=1)
        self.register_buffer("positional_embedding",
                             torch.from_numpy(sinusoids(n_ctx, n_state)), persistent=False)
        self.blocks = nn.ModuleList(WhisperBlock(n_state, n_head) for _ in range(n_layer))
        self.ln_post = nn.LayerNorm(n_state, eps=1e-5)

    def forward(self, mel: torch.Tensor, n_frames: torch.Tensor | None = None) -> torch.Tensor:
        """mel [B, T, 80] -> PPG [B, T//2, n_state].

        n_frames [B] gives the real mel-frame count per row of zero-padded
        rows: keys beyond ceil(n_frames / 2) are masked (the k=3 conv
        boundary still reaches the last <= 2 real output frames).

        The mel is cast to `compute_dtype` and the two stem convolutions
        run in it (weights cast), as in the JAX package, whose first
        LayerNorm (parameters in float32) takes the blocks back to float32;
        here the stem's output is cast back."""
        dt = self.compute_dtype
        x = mel.to(dt).transpose(1, 2)
        for conv in (self.conv1, self.conv2):
            x = F.gelu(F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride,
                                conv.padding))
        x = x.transpose(1, 2)
        x = (x + self.positional_embedding[: x.shape[1]]).to(dt).float()
        key_mask = None
        if n_frames is not None:
            n_keys = (n_frames + 1) // 2  # Conv1d(k=3, s=2, p=1): ceil(n / 2)
            key_mask = torch.arange(x.shape[1], device=x.device)[None, :] < n_keys[:, None]
        for block in self.blocks:
            x = block(x, key_mask)
        return self.ln_post(x)


def load_whisper_encoder(ckpt_path: str, device: str | torch.device | None = "cuda",
                         compute_dtype: torch.dtype = torch.float32) -> WhisperEncoder:
    """Reference `large-v2.pt` ({dims, model_state_dict}) -> the encoder with
    the last quarter of its blocks cut (32 -> 24), weights cast to float32,
    in eval mode on `device` (the card by default). `compute_dtype` is the
    stem's (WhisperEncoder.forward)."""
    dev = resolve_device(device)
    ckpt = torch_load_weights(ckpt_path)
    dims = ckpt["dims"]
    n_layer = dims["n_audio_layer"] - dims["n_audio_layer"] // 4
    with torch.device("meta"):  # the weights come from the file; no random init
        model = WhisperEncoder(n_mels=dims["n_mels"], n_ctx=dims["n_audio_ctx"],
                               n_state=dims["n_audio_state"], n_head=dims["n_audio_head"],
                               n_layer=n_layer, compute_dtype=compute_dtype)
    keep = set(model.state_dict())
    sd = {k.removeprefix("encoder."): v for k, v in ckpt["model_state_dict"].items()
          if k.startswith("encoder.") and k.removeprefix("encoder.") in keep}
    model.load_state_dict(sd, strict=True, assign=True)
    # cast on the device: half the bytes cross the bus and the host does no
    # conversion; float16 -> float32 is exact
    return model.to(dev).float().eval()


def ppg_window_batch(model: WhisperEncoder, windows: np.ndarray, n_samples: np.ndarray,
                     rng: torch.Generator | None = None,
                     as_numpy: bool = True) -> np.ndarray | torch.Tensor:
    """[B, W] zero-padded windows (W = WINDOW_SAMPLES, or a shorter bucket of
    the preprocessing driver) + [B] real lengths -> PPG [B, W // PPG_HOP,
    n_state] (rows valid to n_samples // 320), in one call on the model's
    device.

    rng (a CPU torch.Generator) adds the inference-time 0.1-sigma mel noise,
    drawn on the CPU so that the card and the CPU get the same noise; None
    is the training-prep path (prepare/preprocess_ppg.py:34-38).
    as_numpy=False returns the device tensor without waiting for it, so the
    caller can keep several batches in flight and read each with .cpu()
    later; the inputs go up with non-blocking copies, which stay
    asynchronous when they are pinned CPU tensors (the caller must then not
    write to them again: the preprocessing driver fills fresh ones)."""
    dev = next(model.parameters()).device
    lens = torch.as_tensor(n_samples, dtype=torch.int64).to(dev, non_blocking=True)
    with torch.inference_mode():
        mel = log_mel_spectrogram(
            torch.as_tensor(windows, dtype=torch.float32).to(dev, non_blocking=True), lens)
        if rng is not None:
            mel = mel + (torch.randn(mel.shape, generator=rng) * MEL_NOISE).to(dev)
        out = model(mel, lens // HOP_LENGTH)
    return out.cpu().numpy() if as_numpy else out


def ppg_natural(model: WhisperEncoder, audio16k: np.ndarray,
                rng: torch.Generator | None = None) -> np.ndarray:
    """PPG [len // 320, n_state] of one window of at most 15 s (a whole
    number of 320-sample frames) run at its natural length, with nothing
    padded or masked, as whisper-vits-svc runs every window
    (whisper/inference.py:43-50). The streaming extractor runs each of its
    windows so.

    The zero-padded, masked row that `pred_ppg` gives its last window (and
    preprocessing gives its short rows) differs from this at every frame:
    the STFT reflects at the window's end where the padded row has zeros,
    the stem's convolutions pad with zeros where the padded row has
    floored mel frames, and attention carries the difference to the whole
    window. `tests/test_torch_extractors.py` pins that gap; the offline
    paths keep the padded row, as the JAX package computes it."""
    audio16k = np.asarray(audio16k, np.float32)
    assert 0 < len(audio16k) <= WINDOW_SAMPLES and len(audio16k) % PPG_HOP == 0
    return ppg_window_batch(model, audio16k[None], np.asarray([len(audio16k)], np.int64),
                            rng)[0]


def pred_ppg(model: WhisperEncoder, audio16k: np.ndarray,
             rng: torch.Generator | None = None) -> np.ndarray:
    """Whole-utterance PPG [len // 320, n_state] (reference
    whisper/inference.py:32-62): 15 s windows, the remainder zero-padded to
    a whole window with a length mask, all in one batched call; per-window
    outputs cut to window_samples // 320 frames and concatenated. The
    remainder's window is not `ppg_natural`'s (see there)."""
    audln = len(audio16k)
    n_full = audln // WINDOW_SAMPLES
    rem = audln - n_full * WINDOW_SAMPLES
    n_win = n_full + (1 if rem > 0 else 0)
    if n_win == 0:
        return np.zeros((0, model.n_state), np.float32)
    windows = np.zeros((n_win, WINDOW_SAMPLES), np.float32)
    lens = np.full((n_win,), WINDOW_SAMPLES, np.int64)
    if n_full:
        windows[:n_full] = audio16k[: n_full * WINDOW_SAMPLES].reshape(n_full, WINDOW_SAMPLES)
    if rem > 0:
        windows[-1, :rem] = audio16k[n_full * WINDOW_SAMPLES :]
        lens[-1] = rem
    ppg = ppg_window_batch(model, windows, lens, rng)
    return np.concatenate([ppg[i, : lens[i] // PPG_HOP] for i in range(n_win)], axis=0)
