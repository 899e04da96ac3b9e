"""CREPE pitch tracker: conv stack and Viterbi decode (JAX
whisper_vits_svc_tpu/models/crepe.py; reference torchcrepe model.py:14-134,
core.py:539-700, decode.py:55-80, convert.py:12-57, filter.py:10-134).

  * 6 convolution layers over 1024-sample windows (the reference's Conv2d
    parameters, kernels of width 1, run as Conv1d), each ReLU, BatchNorm
    (eval: folded to a per-channel scale and bias, as the JAX package
    folds it at load) and a max-pool by 2, on the card one launch a layer
    of the CREPE convolution kernel (ops/crepe_conv_cuda.py), on the CPU
    its plain version; a sigmoid over 360 bins of 20 cents;
  * framing on the host, per-frame mean/std normalisation on the device, in
    batches of 512 frames;
  * the Viterbi decode over the frequency-masked, softmaxed bin
    probabilities with the reference's triangular transition matrix: the
    trellis runs on the model's device, on the card as one launch of the
    trellis kernel (ops/viterbi_cuda.py), on the CPU as its plain version,
    one 360 x 360 max and argmax per frame; the backtrace on the host;
  * cents -> Hz with the optional triangular dither, and NaN-aware mean and
    median filters, in numpy.

Random draws (the audio noise, the dither) come from a numpy Generator in
the JAX package's order, so the same seed gives the same F0.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..ops import crepe_conv_cuda, viterbi_cuda
from ..utils.device import resolve_device
from .convert import torch_load_weights

CENTS_PER_BIN = 20.0
PITCH_BINS = 360
SAMPLE_RATE = 16000
WINDOW_SIZE = 1024
CENTS_OFFSET = 1997.3794084376191
MAX_FMAX = 2006.0
BN_EPS = 0.0010000000474974513  # torchcrepe's BatchNorm2d eps (model.py)

CAPACITIES = {"full": ([1024, 128, 128, 128, 256, 512], 2048),
              "tiny": ([128, 16, 16, 16, 32, 64], 256)}


class Crepe(nn.Module):
    """capacity "full" or "tiny" (torchcrepe model.py:20-28)."""

    def __init__(self, capacity: str = "full"):
        super().__init__()
        if capacity not in CAPACITIES:
            raise ValueError(capacity)
        out_ch, self.in_features = CAPACITIES[capacity]
        in_ch = [1] + out_ch[:-1]
        for i in range(6):
            k, stride = ((512, 1), (4, 1)) if i == 0 else ((64, 1), (1, 1))
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_ch[i], out_ch[i], k, stride=stride))
            setattr(self, f"conv{i + 1}_BN",
                    nn.BatchNorm2d(out_ch[i], eps=BN_EPS, momentum=0.0))
        self.classifier = nn.Linear(self.in_features, PITCH_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 1024] normalised windows -> [N, 360] sigmoid probabilities.

        The reference's (K, 1) Conv2d kernels run as Conv1d over [N, C, H],
        a layer (padding, convolution, ReLU, the folded BatchNorm, the pool)
        a call of `crepe_conv_cuda.conv_relu_affine_pool`: one launch of the
        CREPE convolution kernel on the card, the plain F.conv1d sequence on
        the CPU. (For the 2-D form cuDNN's heuristics pick FFT algorithms at
        these shapes: on an H100 467 ms and 32.6 GiB for 512 frames of
        "full", against 66 ms and 1.5 GiB as Conv1d;
        tools/crepe_conv_probe.py.)"""
        x = frames[:, None, :]  # [N, 1, 1024]
        for i in range(1, 7):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"conv{i}_BN")
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
            x = crepe_conv_cuda.conv_relu_affine_pool(
                x, conv.weight[..., 0], conv.bias, scale, shift, conv.stride[0],
                (254, 254) if i == 1 else (31, 32))
        # flatten in (h, c) order, as torchcrepe (and the JAX NHWC reshape) do
        return torch.sigmoid(self.classifier(x.transpose(1, 2).reshape(len(x), self.in_features)))


def load_crepe(ckpt_path: str, capacity: str | None = None,
               device: str | torch.device | None = "cuda") -> Crepe:
    """torchcrepe `full.pth` / `tiny.pth` state_dict -> Crepe in eval mode on
    `device` (the card by default); capacity None reads it from the first
    conv's width."""
    dev = resolve_device(device)
    sd = torch_load_weights(ckpt_path)
    if capacity is None:
        width = sd["conv1.weight"].shape[0]
        capacity = next(c for c, (out_ch, _) in CAPACITIES.items() if out_ch[0] == width)
    model = Crepe(capacity)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


# ------------------------------------------------------------------ framing


def frame_audio(audio: np.ndarray, hop_length: int) -> np.ndarray:
    """Pad WINDOW/2 and frame (torchcrepe core.py:preprocess). [T] -> [N, 1024]."""
    total_frames = 1 + len(audio) // hop_length
    padded = np.pad(audio, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    idx = np.arange(total_frames)[:, None] * hop_length + np.arange(WINDOW_SIZE)[None, :]
    return padded[idx].astype(np.float32)


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame mean-centre and std-scale, the std Bessel-corrected
    (core.py:695-700)."""
    frames = frames - frames.mean(dim=1, keepdim=True)
    return frames / frames.std(dim=1, keepdim=True).clamp_min(1e-10)


# ------------------------------------------------------------------ decoding


def bins_to_cents(bins, dither_rng: np.random.Generator | None = None):
    cents = CENTS_PER_BIN * np.asarray(bins, np.float64) + CENTS_OFFSET
    if dither_rng is not None:
        # triangular dither removes the quantisation error (convert.py:52-57)
        cents = cents + dither_rng.triangular(-CENTS_PER_BIN, 0.0, CENTS_PER_BIN, cents.shape)
    return cents


def cents_to_frequency(cents):
    return 10.0 * 2.0 ** (np.asarray(cents) / 1200.0)


def frequency_to_bins(freq, quantize=np.floor):
    cents = 1200.0 * np.log2(np.asarray(freq, np.float64) / 10.0)
    return quantize((cents - CENTS_OFFSET) / CENTS_PER_BIN).astype(np.int64)


def _transition_matrix() -> np.ndarray:
    xx, yy = np.meshgrid(range(PITCH_BINS), range(PITCH_BINS))
    t = np.maximum(12 - abs(xx - yy), 0).astype(np.float64)
    return (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


def _log_transition() -> np.ndarray:
    """log(transition + 1e-30) over the full [from, to] matrix, float32."""
    return np.log(_transition_matrix() + np.float32(1e-30))


@lru_cache(maxsize=None)
def banded_transition() -> viterbi_cuda.BandedTransition:
    """`_log_transition()` in the trellis kernel's banded form."""
    return viterbi_cuda.banded(_log_transition())


def viterbi_trellis(log_prob: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, S] log observation probabilities on any device -> (the last
    step's values [S] float32, backpointers [T - 1, S] int16) on that device:
    one kernel launch on the card, the plain loop on the CPU
    (`viterbi_cuda.viterbi_trellis`), bitwise the same.

    One step: scores[from, to] = value[from] + log_trans[from, to]; the
    pointer is the first argmax over `from` (torch.argmax's tie rule), the
    value the max plus the observation."""
    return viterbi_cuda.viterbi_trellis(log_prob, None, banded_transition())


def log_observations(probs: np.ndarray) -> np.ndarray:
    """[T, 360] softmaxed probabilities (`viterbi_observations`) -> the
    trellis's log observations, float32."""
    return np.log(np.maximum(probs, 1e-30)).astype(np.float32)


def viterbi_decode(probs: np.ndarray, device: str | torch.device | None = "cuda") -> np.ndarray:
    """[T, 360] probabilities (softmaxed) -> [T] bin path: the HMM of
    librosa.sequence.viterbi with the reference's transition matrix
    (decode.py:55-80); the trellis on `device` (the card unless the caller
    asks for the CPU), the backtrace on the host."""
    value, ptrs = viterbi_trellis(torch.from_numpy(log_observations(probs))
                                  .to(resolve_device(device)))
    value, ptrs = value.cpu().numpy(), ptrs.cpu().numpy()
    path = np.empty(len(probs), np.int64)
    path[-1] = int(np.argmax(value))
    for t in range(len(probs) - 2, -1, -1):
        path[t] = ptrs[t, path[t + 1]]
    return path


# ------------------------------------------------------------------ filters


def nan_mean_filter(x: np.ndarray, win_length: int = 9) -> np.ndarray:
    """NaN-aware moving average (reference filter.mean, filter.py:10-62)."""
    mask = ~np.isnan(x)
    vals = np.where(mask, x, 0.0)
    kernel = np.ones(win_length)
    pad = win_length // 2
    summed = np.convolve(np.pad(vals, (pad, pad)), kernel, "valid")
    count = np.convolve(np.pad(mask.astype(np.float64), (pad, pad)), kernel, "valid")
    out = summed / np.maximum(count, 1.0)
    out[out == 0] = np.nan
    return out[: len(x)]


def nan_median_filter(x: np.ndarray, win_length: int) -> np.ndarray:
    """NaN-aware moving median (reference filter.median, filter.py:65-134)."""
    pad = win_length // 2
    mask = ~np.isnan(x)
    vals = np.where(mask, x, 0.0)
    vp = np.pad(vals, (pad, pad), mode="reflect")
    mp = np.pad(mask.astype(np.float64), (pad, pad), mode="constant")
    idx = np.arange(len(x))[:, None] + np.arange(win_length)[None, :]
    win_v = np.where(mp[idx] > 0, vp[idx], np.inf)
    win_sorted = np.sort(win_v, axis=1)
    count = mp[idx].sum(axis=1).astype(np.int64)
    out = win_sorted[np.arange(len(x)), np.maximum((count - 1) // 2, 0)]
    out[np.isinf(out)] = np.nan
    return out


# ------------------------------------------------------------------ pipeline


def crepe_probabilities(model: Crepe, frames: np.ndarray, batch_size: int = 512) -> np.ndarray:
    """[N, 1024] raw frames -> [N, 360] probabilities, normalised and run on
    the model's device in batches of batch_size frames (the last one
    zero-padded; frames are independent, so values do not depend on it)."""
    dev = next(model.parameters()).device
    n = len(frames)
    frames = np.pad(frames, ((0, (-n) % batch_size), (0, 0)))
    with torch.inference_mode():
        probs = [model(normalize_frames(torch.from_numpy(frames[i : i + batch_size]).to(dev)))
                 for i in range(0, len(frames), batch_size)]
        return torch.cat(probs).cpu().numpy()[:n]


def viterbi_observations(probs: np.ndarray, fmin: float = 50.0,
                         fmax: float = 1000.0) -> np.ndarray:
    """What the decode reads: the bins outside [fmin, fmax] masked
    (core.py:postprocess), then a softmax over bins (decode.py:64-67)."""
    masked = probs.copy()
    masked[:, : frequency_to_bins(fmin)] = -np.inf
    masked[:, frequency_to_bins(fmax, np.ceil) :] = -np.inf
    ex = np.exp(masked - masked.max(axis=1, keepdims=True))
    return ex / ex.sum(axis=1, keepdims=True)


def predict(model: Crepe, audio16k: np.ndarray, hop_length: int = 160, fmin: float = 50.0,
            fmax: float = 1000.0, batch_size: int = 512,
            dither_rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (pitch Hz [T], periodicity [T]) (torchcrepe predict, core.py:49)."""
    probs = crepe_probabilities(model, frame_audio(audio16k, hop_length), batch_size)
    return _decode(probs, fmin, fmax, dither_rng, next(model.parameters()).device)


def _decode(probs: np.ndarray, fmin: float, fmax: float,
            dither_rng: np.random.Generator | None, device) -> tuple[np.ndarray, np.ndarray]:
    """[N, 360] probabilities -> (pitch Hz [N], periodicity [N]): the Viterbi
    path (on `device`), dithered cents, the path's probabilities."""
    bins = viterbi_decode(viterbi_observations(probs, fmin, fmax), device=device)
    pitch = cents_to_frequency(bins_to_cents(bins, dither_rng)).astype(np.float32)
    periodicity = probs[np.arange(len(probs)), bins].astype(np.float32)
    return pitch, periodicity


def _noisy(audio16k: np.ndarray, rng: np.random.Generator | None) -> np.ndarray:
    audio = audio16k.astype(np.float32)
    if rng is not None:
        audio = audio + rng.standard_normal(len(audio)).astype(np.float32) * 0.001
    return audio


def compute_f0(model: Crepe, audio16k: np.ndarray, rng: np.random.Generator | None = None,
               batch_size: int = 512) -> np.ndarray:
    """Train-prep F0 at hop 160 (prepare/preprocess_crepe.py:11-44):
    +0.001 sigma audio noise, median-7 periodicity, mean-5 pitch smoothing,
    pitch[periodicity < 0.5] = 0."""
    probs = crepe_probabilities(model, train_frames(audio16k, rng), batch_size)
    return f0_from_probabilities(probs, rng, next(model.parameters()).device)


def train_frames(audio16k: np.ndarray, rng: np.random.Generator | None) -> np.ndarray:
    """compute_f0's [N, 1024] frames: the audio with its noise drawn from
    `rng`, framed at hop 160."""
    return frame_audio(_noisy(audio16k, rng), 160)


def f0_from_probabilities(probs: np.ndarray, rng: np.random.Generator | None,
                          device) -> np.ndarray:
    """compute_f0 from the probabilities of `train_frames`: the decode, its
    dither drawn from the same `rng` after the noise, and the filters."""
    pitch, peri = _decode(probs, 50.0, 1000.0, rng, device)
    peri = nan_median_filter(peri.astype(np.float64), 7)
    pitch = nan_mean_filter(pitch.astype(np.float64), 5)
    pitch = np.where(np.nan_to_num(peri) < 0.5, 0.0, np.nan_to_num(pitch))
    return pitch.astype(np.float32)


def compute_f0_sing(model: Crepe, audio16k: np.ndarray,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Inference F0 (pitch/inference.py:74-101): +0.001 sigma audio noise,
    hop 320, x2 repeat to the 160-hop rate, mean-5 smoothing (no U/V gate)."""
    pitch, _ = predict(model, _noisy(audio16k, rng), hop_length=320, dither_rng=rng)
    pitch = nan_mean_filter(np.repeat(pitch, 2).astype(np.float64), 5)
    return np.nan_to_num(pitch).astype(np.float32)
