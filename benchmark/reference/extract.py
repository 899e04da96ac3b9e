"""Plain PyTorch of so-vits-svc 5.0's audio front end and of the live
stream's windowing, frozen as the benchmark's reference.

  * whisper-large-v2's audio encoder as whisper-vits-svc runs it
    (whisper/audio.py:log_mel_spectrogram, whisper/model.py:AudioEncoder,
    whisper/inference.py: the decoder and the last quarter of the blocks
    deleted): the log-mel of a window at its natural length, the GELU
    convolution stem, sinusoid positions cut to the window, pre-LN blocks,
    ln_post; no key mask, since nothing is padded;
  * HuBERT-soft (github.com/bshall/hubert, hubert_model.py): the 7-layer
    convolution front end with its GroupNorm, the projection, the
    weight-normed grouped positional convolution (dim 2), post-norm
    transformer layers, the 256-d projection, `units` at natural length;
  * CREPE (torchcrepe model.py, core.py, decode.py, convert.py, filter.py):
    the six convolutions, each ReLU, BatchNorm in eval and a max-pool by 2,
    the sigmoid classifier; framing and per-frame normalisation; the
    fmin/fmax mask, the softmax and a Viterbi decode with torchcrepe's
    transition matrix; cents to Hz; the NaN-aware mean filter;
  * the stream: whisper on the 15 s before each push, HuBERT on
    [context | block], CREPE frame i on the 1024 samples around i * 320,
    and the pitch decoded with a fixed lag behind the newest frame.

One plain torch call a layer, nothing fused, no cache, no batching across
windows of different lengths; float32, with TF32 off by the caller
(compare.py::tf32). Parameter names are the published state_dicts'.
Departures from the published code:

  * float32 throughout; the published inference casts whisper and HuBERT
    to float16 on a GPU (`.half()` in whisper/inference.py and
    hubert/inference.py);
  * whisper's positional table is the published `sinusoids` computed in
    float64 and rounded once to float32. The published function computes
    it in float32 arithmetic, and load_state_dict then puts large-v2.pt's
    float16 copy in its place; neither rounding is part of the model;
  * the mel filterbank is the Slaney formula written out
    (librosa.filters.mel(sr=16000, n_fft=400, n_mels=80), which whisper
    ships as mel_filters.npz);
  * HuBERT's transformer layer is written out (nn.TransformerEncoderLayer's
    post-norm equations in eval mode) rather than the module, whose eval
    fast path is a fused kernel;
  * CREPE's (K, 1) Conv2d kernels run as Conv1d over the same sums (for the
    2-D form cuDNN picks FFT algorithms at these shapes: 32.6 GiB for 512
    frames of "full"), over frames in blocks;
  * the stream's decode draws no dither (torchcrepe's bins_to_cents adds a
    triangular one to offline pitch) and runs its trellis in float64;
  * the stream itself has no published counterpart: its windowing is the
    program's design (infer/stream_extract.py of the port), written out here
    plainly.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SAMPLE_RATE = 16000
N_FFT = 400
MEL_HOP = 160
N_MELS = 80
HOP = 320                     # the stream's 320-hop grid: a PPG, unit or CREPE frame
WINDOW_SAMPLES = 15 * SAMPLE_RATE
CREPE_WINDOW = 1024
PITCH_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
CREPE_BN_EPS = 0.0010000000474974513
CREPE_CAPACITIES = {"full": ([1024, 128, 128, 128, 256, 512], 2048),
                    "tiny": ([128, 16, 16, 16, 32, 64], 256)}


# ------------------------------------------------------------------ whisper


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=None)
def mel_filters(sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    """[n_mels, 1 + n_fft // 2] Slaney mel filterbank over 0 .. sr / 2,
    Slaney-normalised, float32."""
    fft_hz = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_hz)
    ramps = mel_hz[:, None] - fft_hz[None, :]
    weights = np.zeros((n_mels, len(fft_hz)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_hz[2 : n_mels + 2] - mel_hz[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] 16 kHz rows of one natural length -> [B, 80, T // 160]: hann(400),
    hop 160, centred with reflection, the power spectrum with its last frame
    dropped, the mel filters, log10 clamped at 1e-10, each row floored at
    its max - 8, then (x + 4) / 4."""
    window = torch.hann_window(N_FFT, device=audio.device)
    stft = torch.stft(audio, N_FFT, MEL_HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2
    mel = torch.from_numpy(mel_filters()).to(audio.device) @ magnitudes
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.tensor(np.concatenate([np.sin(t), np.cos(t)], axis=1), dtype=torch.float32)


class WhisperAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        b, t, d = q.shape
        scale = (d // self.n_head) ** -0.25
        q = q.view(b, t, self.n_head, -1).permute(0, 2, 1, 3) * scale
        k = k.view(b, t, self.n_head, -1).permute(0, 2, 3, 1) * scale
        v = v.view(b, t, self.n_head, -1).permute(0, 2, 1, 3)
        w = (q @ k).softmax(dim=-1)
        return self.out((w @ v).permute(0, 2, 1, 3).flatten(start_dim=2))


class WhisperBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = WhisperAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class WhisperEncoder(nn.Module):
    """The audio encoder with `n_layer` blocks (whisper-vits-svc keeps
    n_audio_layer - n_audio_layer // 4 of them: 24 of large-v2's 32)."""

    def __init__(self, n_mels: int, n_ctx: int, n_state: int, n_head: int, n_layer: int):
        super().__init__()
        self.conv1 = nn.Conv1d(n_mels, n_state, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(n_state, n_state, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", sinusoids(n_ctx, n_state), persistent=False)
        self.blocks = nn.ModuleList(WhisperBlock(n_state, n_head) for _ in range(n_layer))
        self.ln_post = nn.LayerNorm(n_state)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, T] -> [B, ceil(T / 2), n_state]."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).permute(0, 2, 1)
        x = x + self.positional_embedding[: x.shape[1]]
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


def kept_layers(n_audio_layer: int) -> int:
    """whisper-vits-svc's cut: the last quarter of the blocks deleted."""
    return n_audio_layer - n_audio_layer // 4


def whisper_encoder(dims: dict) -> WhisperEncoder:
    """The cut encoder of a checkpoint's `dims`."""
    return WhisperEncoder(dims["n_mels"], dims["n_audio_ctx"], dims["n_audio_state"],
                          dims["n_audio_head"], kept_layers(dims["n_audio_layer"]))


def ppg(encoder: WhisperEncoder, windows: torch.Tensor) -> torch.Tensor:
    """[B, n] windows of one natural length n -> PPG [B, n // 320, n_state]
    (whisper/inference.py: the encoder's output cut to n // 320 frames)."""
    return encoder(log_mel(windows))[:, : windows.shape[1] // HOP]


# ------------------------------------------------------------------ HuBERT-soft


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv1d(1, 512, 10, 5, bias=False)
        self.norm0 = nn.GroupNorm(512, 512)
        for i, k in enumerate((3, 3, 3, 3, 2, 2), start=1):
            setattr(self, f"conv{i}", nn.Conv1d(512, 512, k, 2, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.norm0(self.conv0(x)))
        for i in range(1, 7):
            x = F.gelu(getattr(self, f"conv{i}")(x))
        return x


class FeatureProjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.LayerNorm(512)
        self.projection = nn.Linear(512, 768)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class _WeightNormConvParams(nn.Module):
    """nn.utils.weight_norm(Conv1d(768, 768, 128, padding=64, groups=16),
    dim=2)'s parameters."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(768))
        self.weight_g = nn.Parameter(torch.ones(1, 1, 128))
        self.weight_v = nn.Parameter(torch.zeros(768, 48, 128))


class PositionalConvEmbedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _WeightNormConvParams()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        # torch._weight_norm(v, g, 2): v * (g / norm of v over every dim but 2)
        w = c.weight_v * (c.weight_g / c.weight_v.square().sum(dim=(0, 1), keepdim=True).sqrt())
        y = F.conv1d(x.transpose(1, 2), w, c.bias, padding=64, groups=16)
        return F.gelu(y[:, :, :-1]).transpose(1, 2)


class TransformerLayer(nn.Module):
    """nn.TransformerEncoderLayer(768, 12, 3072, activation="gelu",
    batch_first=True) in eval mode: x = norm1(x + attention(x)), then
    x = norm2(x + linear2(gelu(linear1(x))))."""

    def __init__(self, d: int = 768, heads: int = 12, ff: int = 3072):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        self.self_attn.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.self_attn.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.self_attn.out_proj = nn.Linear(d, d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        sa = self.self_attn
        b, t, d = x.shape
        q, k, v = (y.view(b, t, self.heads, -1).transpose(1, 2)
                   for y in F.linear(x, sa.in_proj_weight, sa.in_proj_bias).chunk(3, dim=-1))
        w = ((q @ k.transpose(-1, -2)) / math.sqrt(d // self.heads)).softmax(dim=-1)
        return sa.out_proj((w @ v).transpose(1, 2).reshape(b, t, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attention(x))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class HubertSoft(nn.Module):
    """hubert_soft: HuBERT-Base with the soft-unit projection; its two
    pre-training parameters are kept so that the state_dict is the
    published one."""

    def __init__(self, n_layers: int = 12):
        super().__init__()
        self.feature_extractor = FeatureExtractor()
        self.feature_projection = FeatureProjection()
        self.positional_embedding = PositionalConvEmbedding()
        self.norm = nn.LayerNorm(768)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(TransformerLayer() for _ in range(n_layers))
        self.proj = nn.Linear(768, 256)
        self.masked_spec_embed = nn.Parameter(torch.zeros(768))
        self.label_embedding = nn.Embedding(100, 256)

    def units(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, n] 16 kHz rows of one natural length -> [B, frames, 256]."""
        x = F.pad(wav, ((400 - 320) // 2, (400 - 320) // 2))[:, None]
        x = self.feature_projection(self.feature_extractor(x).transpose(1, 2))
        x = self.norm(x + self.positional_embedding(x))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.proj(x)


# ------------------------------------------------------------------ CREPE


class Crepe(nn.Module):
    def __init__(self, capacity: str = "full"):
        super().__init__()
        out_ch, self.in_features = CREPE_CAPACITIES[capacity]
        in_ch = [1] + out_ch[:-1]
        for i in range(6):
            kernel, stride = ((512, 1), (4, 1)) if i == 0 else ((64, 1), (1, 1))
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_ch[i], out_ch[i], kernel, stride))
            setattr(self, f"conv{i + 1}_BN",
                    nn.BatchNorm2d(out_ch[i], eps=CREPE_BN_EPS, momentum=0.0))
        self.classifier = nn.Linear(self.in_features, PITCH_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 1024] normalised frames -> [N, 360] probabilities."""
        x = frames[:, None]
        for i in range(1, 7):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"conv{i}_BN")
            x = F.pad(x, (254, 254) if i == 1 else (31, 32))
            x = F.relu(F.conv1d(x, conv.weight[..., 0], conv.bias, stride=conv.stride[0]))
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
            x = F.max_pool1d(x, 2, 2)
        return torch.sigmoid(self.classifier(x.transpose(1, 2).reshape(len(x), self.in_features)))


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """Each frame less its mean, over its (Bessel) standard deviation."""
    frames = frames - frames.mean(dim=1, keepdim=True)
    return frames / torch.clamp(frames.std(dim=1, keepdim=True), min=1e-10)


def crepe_probabilities(model: Crepe, frames: torch.Tensor, block: int = 512) -> torch.Tensor:
    """[N, 1024] raw frames -> [N, 360], `block` frames a call."""
    return torch.cat([model(normalize(frames[i : i + block]))
                      for i in range(0, len(frames), block)])


def frequency_to_bin(hz: float, quantize=math.floor) -> int:
    return int(quantize((1200.0 * math.log2(hz / 10.0) - CENTS_OFFSET) / CENTS_PER_BIN))


def observations(probs: torch.Tensor, fmin: float = 50.0, fmax: float = 1000.0) -> np.ndarray:
    """What the decode reads: the bins outside [fmin, fmax] set to -inf, a
    softmax over bins, then librosa's log(p + tiny), float64 [N, 360]."""
    masked = probs.clone()
    masked[:, : frequency_to_bin(fmin)] = -float("inf")
    masked[:, frequency_to_bin(fmax, math.ceil) :] = -float("inf")
    soft = torch.softmax(masked, dim=1).cpu().numpy()
    return np.log(soft.astype(np.float64) + np.finfo(np.float32).tiny)


@lru_cache(maxsize=None)
def log_transition() -> np.ndarray:
    """log of torchcrepe's transition matrix [from, to]: a triangle of
    width 12 bins, rows normalised."""
    xx, yy = np.meshgrid(range(PITCH_BINS), range(PITCH_BINS))
    t = np.maximum(12 - abs(xx - yy), 0).astype(np.float64)
    return np.log(t / t.sum(axis=1, keepdims=True) + np.finfo(np.float64).tiny)


def bin_to_hz(bins) -> np.ndarray:
    return 10.0 * 2.0 ** ((CENTS_PER_BIN * np.asarray(bins, np.float64) + CENTS_OFFSET) / 1200.0)


def mean_filter(x: np.ndarray, win: int) -> np.ndarray:
    """torchcrepe filter.mean: the mean over a centred window of `win`,
    the window's ends past the signal left out of the count."""
    pad = win // 2
    s = np.convolve(np.pad(x, (pad, pad)), np.ones(win), "valid")
    n = np.convolve(np.pad(np.ones(len(x)), (pad, pad)), np.ones(win), "valid")
    return s / n


class FixedLagPitch:
    """The stream's pitch: a Viterbi trellis advanced frame by frame; after
    each push the frames [emitted, hi) are emitted from the path backtraced
    from the best state of the newest frame, at 100 fps (x2) after the
    mean-5 filter. A frame keeps the Hz it had when emitted, and the
    filter's context before the emitted frames is that frame's Hz; the
    first emission starts at the signal's edge. `filter_frames` 1 leaves
    the filter out (a fault the benchmark plants); `dtype` is the trellis's
    (float32: the program's precision, in place of the float64 above)."""

    def __init__(self, filter_frames: int = 5, dtype=np.float64):
        self.filter_frames = filter_frames
        self.dtype = dtype
        self.value = None
        self.ptrs: list[np.ndarray] = []   # ptrs[t - 1]: frame t's backpointers
        self.hz: dict[int, float] = {}
        self.emitted = 0

    @property
    def head(self) -> int:
        return -1 if self.value is None else len(self.ptrs)

    def advance(self, obs: np.ndarray) -> None:
        trans = log_transition().astype(self.dtype)
        for o in np.asarray(obs, self.dtype):
            if self.value is None:
                self.value = o + self.dtype(math.log(1.0 / PITCH_BINS))
            else:
                scores = self.value[:, None] + trans
                self.ptrs.append(scores.argmax(axis=0))
                self.value = scores.max(axis=0) + o

    def emit(self, hi: int) -> np.ndarray:
        """Hz at 100 fps of the 320-hop frames [emitted, hi) (hi <= head)."""
        lo, head = self.emitted, self.head
        b = int(np.argmax(self.value))
        path = [b]
        for t in range(head, lo, -1):
            b = int(self.ptrs[t - 1][b])
            path.append(b)
        for f, hz in zip(range(lo, head + 1), bin_to_hz(path[::-1])):
            self.hz[f] = float(hz)
        ctx = max(0, lo - 1)
        raw = np.asarray([self.hz[f] for f in range(ctx, min(head, hi) + 1)])
        filt = mean_filter(np.repeat(raw, 2), self.filter_frames)
        self.emitted = hi
        off = 2 * (lo - ctx)
        return filt[off : off + 2 * (hi - lo)]


# ------------------------------------------------------------------ the stream's windows


def whisper_window(pushed: int) -> tuple[int, int]:
    """Samples [a, pushed) of whisper's window after `pushed` samples: the
    last 15 s, or all of the stream while it is shorter."""
    return max(0, pushed - WINDOW_SAMPLES), pushed


def hubert_window(pushed: int, block: int, context_seconds: float) -> tuple[int, int]:
    """Samples [a, pushed) of HuBERT's window: the context (whole 320-hop
    frames) and the block."""
    context = int(round(context_seconds * SAMPLE_RATE / HOP)) * HOP
    return max(0, pushed - context - block), pushed


def crepe_head(pushed: int) -> int:
    """The newest CREPE frame whose 1024 samples around frame * 320 have all
    arrived after `pushed` samples."""
    return min((pushed - CREPE_WINDOW // 2) // HOP, pushed // HOP)


def crepe_frames(stream: torch.Tensor, frames: range) -> torch.Tensor:
    """[len(frames), 1024]: frame i's samples [i * 320 - 512, i * 320 + 512)
    of the stream, zero before its start."""
    padded = F.pad(stream, (CREPE_WINDOW // 2, 0))
    return padded.unfold(0, CREPE_WINDOW, HOP)[frames.start : frames.stop]
