"""Streaming feature extractors, the audio-in half of block-wise conversion
(JAX whisper_vits_svc_tpu/infer/stream_extract.py).

  * CREPE: a 320-hop frame is computed once its whole 1024-sample support
    has arrived, so every probability row equals the offline one; the
    Viterbi trellis advances online (float32 numpy, the offline trellis's
    adds, maxima and first-index argmaxes), a frame is emitted by
    backtracing from the newest head `lag` frames ahead, and the flush
    backtraces the whole trellis: the offline path.
  * HuBERT: each block runs on [carried context | block] (2 s by default,
    one shape); only the new block's frames are emitted.
  * Whisper: the whole sliding 15 s window is recomputed each block and the
    newest frames kept; while the stream is shorter than 15 s the window
    runs at its natural length, as whisper-vits-svc runs every window
    (`whisper.ppg_natural`, which says how a zero-padded, masked row
    differs).

All three emit on the shared 320-hop grid behind one `lag_frames` pointer
(default 4 frames, 80 ms): CREPE's right support, the mean-5 pitch filter's
centred window and whisper's and HuBERT's edge frames lie inside the lag.
The models run on their device (the card unless the caller asks for the
CPU); the trellis and the bookkeeping run on the host.

`StreamingExtractor.push` opens the span `svc.extract` (utils/profiling.py)
with one child a stage, each closed after the stage's read-back so that
its device work lies inside it: `svc.extract.whisper`, `.hubert`, `.crepe`
(holding `.crepe.trellis`, the host's trellis) and `.emit`; `flush` opens
`.crepe` and `.emit`. `whisper_windows` and `hubert_windows` count the
windows run, `crepe_frames` the CREPE frames the stream needed and
`crepe_rows` the rows launched for them, the static batch's padding
included (`counts`, `add_counts`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import hubert as hubert_mod
from ..models import whisper as whisper_mod
from ..models.crepe import (
    PITCH_BINS,
    Crepe,
    _log_transition,
    bins_to_cents,
    cents_to_frequency,
    crepe_probabilities,
    frequency_to_bins,
    nan_mean_filter,
)
from ..utils.profiling import span
from .stream import model_on

HOP = 320                      # the shared 320-hop feature grid (samples)
CREPE_WINDOW = 1024            # a CREPE frame's support (samples)
_CREPE_BATCH = 64              # static batch of streamed CREPE frames
VEC_DIM = 256                  # HuBERT-soft units

whisper_windows = 0  # sliding whisper windows run
hubert_windows = 0   # carried-context HuBERT windows run
crepe_frames = 0     # CREPE frames the streams needed
crepe_rows = 0       # CREPE rows launched for them (whole static batches)
COUNTERS = ("whisper_windows", "hubert_windows", "crepe_frames", "crepe_rows")


def counts() -> dict:
    """This module's counters, by name."""
    return {name: globals()[name] for name in COUNTERS}


def add_counts(delta: dict) -> None:
    """Add `delta` (a counter's name -> count, as `counts` gives them) to
    the counters."""
    for name, n in delta.items():
        globals()[name] += n


class StreamingWhisper:
    """Sliding 15 s window PPG: `push` appends to a rolling buffer of at most
    15 s and recomputes the whole buffer at its natural length through
    `whisper.ppg_natural` (no mel noise); `frames(lo, hi)` returns the
    global 320-hop frames [lo, hi) of the newest window."""

    def __init__(self, model: whisper_mod.WhisperEncoder,
                 device: str | torch.device | None = "cuda"):
        model_on(model, device)
        self.model = model
        self.window = whisper_mod.WINDOW_SAMPLES
        self.buf = np.zeros(0, np.float32)
        self.total = 0            # samples pushed so far
        self._ppg = None          # [750, D], the newest window's output
        self._start_frame = 0     # global 320-hop index of the window's frame 0

    def push(self, samples: np.ndarray):
        global whisper_windows
        samples = np.asarray(samples, np.float32)
        assert len(samples) % HOP == 0, "block must be a multiple of 320"
        self.buf = np.concatenate([self.buf, samples])[-self.window :]
        self.total += len(samples)
        self._ppg = whisper_mod.ppg_natural(self.model, self.buf)
        self._start_frame = (self.total - len(self.buf)) // HOP
        whisper_windows += 1

    def frames(self, lo: int, hi: int) -> np.ndarray:
        assert lo >= self._start_frame and hi <= self.total // HOP
        s = lo - self._start_frame
        return self._ppg[s : s + (hi - lo)]


class StreamingHubert:
    """Carried-context soft units: each push runs [context | block] through
    `vec_window_batch` (the offline masked window) and emits the new frames.
    While the stream fits the window the run sees all audio since t = 0 and
    equals the offline one; later, attention spans the carried window."""

    def __init__(self, model: hubert_mod.HubertSoft, block_samples: int,
                 context_seconds: float = 2.0, device: str | torch.device | None = "cuda"):
        model_on(model, device)
        ctx = int(round(context_seconds * 16000 / HOP)) * HOP
        self.model = model
        self.win = ctx + block_samples
        self.buf = np.zeros(0, np.float32)
        self.total = 0
        self._vec = None
        self._start_frame = 0

    def push(self, samples: np.ndarray):
        global hubert_windows
        samples = np.asarray(samples, np.float32)
        assert len(samples) % HOP == 0
        self.buf = np.concatenate([self.buf, samples])[-self.win :]
        self.total += len(samples)
        row = np.zeros((1, self.win), np.float32)
        row[0, : len(self.buf)] = self.buf
        n = np.asarray([len(self.buf)], np.int64)
        self._vec = hubert_mod.vec_window_batch(self.model, row, n)[0]
        self._start_frame = (self.total - len(self.buf)) // HOP
        hubert_windows += 1

    def frames(self, lo: int, hi: int) -> np.ndarray:
        assert lo >= self._start_frame
        assert hi <= hubert_mod.hubert_num_frames(len(self.buf)) + self._start_frame
        s = lo - self._start_frame
        return self._vec[s : s + (hi - lo)]


class StreamingCrepe:
    """F0 probabilities frame by frame and an online fixed-lag Viterbi.

    Frame i needs samples [i*320 - 512, i*320 + 512) (the offline framing's
    WINDOW/2 padding); it is computed once they exist, in batches of
    _CREPE_BATCH through `crepe_probabilities`. `decode` backtraces from the
    newest head; at the flush the head is the last frame and the path is the
    offline `viterbi_decode` path."""

    def __init__(self, model: Crepe, fmin: float = 50.0, fmax: float = 1000.0,
                 device: str | torch.device | None = "cuda"):
        model_on(model, device)
        self.model = model
        self.buf = np.zeros(0, np.float32)   # unconsumed samples and their context
        self.buf_start = 0                   # global sample index of buf[0]
        self.total = 0
        self.minidx = int(frequency_to_bins(fmin))
        self.maxidx = int(frequency_to_bins(fmax, np.ceil))
        # float32, the offline trellis's operations one for one, so that the
        # flush's path equals the offline one to the bit
        self.log_trans = _log_transition()
        self.head = -1                       # last frame through the trellis
        self.value = None                    # [360] trellis value at head
        self.ptrs: dict[int, np.ndarray] = {}  # frame t -> backpointers [360]

    def _frame_rows(self, frames: list[int]) -> np.ndarray:
        """[len(frames), 1024] windows of the global frames; samples out of
        range are zero, the offline zero padding at both ends."""
        rows = np.zeros((len(frames), CREPE_WINDOW), np.float32)
        for r, i in enumerate(frames):
            b0 = i * HOP - CREPE_WINDOW // 2 - self.buf_start
            src_lo = max(b0, 0)
            src_hi = min(b0 + CREPE_WINDOW, len(self.buf))
            if src_hi > src_lo:
                rows[r, src_lo - b0 : src_hi - b0] = self.buf[src_lo:src_hi]
        return rows

    def _obs_log(self, rows: np.ndarray) -> np.ndarray:
        """Probabilities -> the fmin/fmax mask -> softmax -> log, float32 (the
        offline decode's observations)."""
        probs = crepe_probabilities(self.model, rows, batch_size=_CREPE_BATCH)
        masked = probs.copy()
        masked[:, : self.minidx] = -np.inf
        masked[:, self.maxidx :] = -np.inf
        ex = np.exp(masked - masked.max(axis=1, keepdims=True))
        soft = ex / ex.sum(axis=1, keepdims=True)
        return np.log(np.maximum(soft, 1e-30))

    def _advance(self, upto_frame: int):
        """Run the trellis through global frames (head, upto_frame]."""
        global crepe_frames, crepe_rows
        new = list(range(self.head + 1, upto_frame + 1))
        if not new:
            return
        obs = self._obs_log(self._frame_rows(new))
        crepe_frames += len(new)
        crepe_rows += -(-len(new) // _CREPE_BATCH) * _CREPE_BATCH
        with span("svc.extract.crepe.trellis"):
            for t, o in zip(new, obs):
                if t == 0:
                    self.value = o + np.float32(np.log(1.0 / PITCH_BINS))
                else:
                    scores = self.value[:, None] + self.log_trans  # [from, to]
                    self.ptrs[t] = scores.argmax(axis=0)
                    self.value = scores.max(axis=0) + o
        self.head = upto_frame

    def push(self, samples: np.ndarray):
        samples = np.asarray(samples, np.float32)
        assert len(samples) % HOP == 0
        self.buf = np.concatenate([self.buf, samples])
        self.total += len(samples)
        # frame i is complete once total >= i*320 + 512
        n_exact = (self.total - CREPE_WINDOW // 2) // HOP + 1
        self._advance(min(n_exact - 1, self.total // HOP))
        # keep only the samples frame head+1 onward still needs
        keep_from = max(0, (self.head + 1) * HOP - CREPE_WINDOW // 2)
        drop = keep_from - self.buf_start
        if drop > 0:
            self.buf = self.buf[drop:]
            self.buf_start = keep_from

    def finish(self):
        """The tail frames, with the offline right zero padding."""
        self._advance(self.total // HOP)

    def decode(self, lo: int, hi: int) -> np.ndarray:
        """Fixed-lag path of global frames [lo, hi), backtraced from the
        newest head (hi - 1 <= head)."""
        assert hi - 1 <= self.head and lo >= 0
        b = int(np.argmax(self.value))
        path_rev = [b]
        for t in range(self.head, lo, -1):
            b = int(self.ptrs[t][b])
            path_rev.append(b)
        path = np.asarray(path_rev[::-1], np.int64)  # frames [lo, head]
        return path[: hi - lo]

    def prune(self, before_frame: int):
        """Drop the backpointers no emission needs any more."""
        for t in [t for t in self.ptrs if t <= before_frame]:
            del self.ptrs[t]


class StreamingExtractor:
    """The three streaming extractors on the shared 320-hop grid.

    push(samples) -> (ppg2, vec2, pit) at the 100 fps synthesis rate (x2
    repeated, as the offline CLI repeats them) for the newly emitted frames;
    flush() drains the lag tail. whisper, hubert and crepe are the port's
    models, on `device`."""

    def __init__(self, whisper: whisper_mod.WhisperEncoder, hubert: hubert_mod.HubertSoft,
                 crepe: Crepe, block_samples: int = 16000, lag_frames: int = 4,
                 hubert_context_seconds: float = 2.0,
                 device: str | torch.device | None = "cuda"):
        assert block_samples % HOP == 0
        assert lag_frames >= 2, "crepe support + filter context need lag >= 2"
        self.block = block_samples
        self.lag = lag_frames
        self.whisper = StreamingWhisper(whisper, device=device)
        self.hubert = StreamingHubert(hubert, block_samples=block_samples,
                                      context_seconds=hubert_context_seconds, device=device)
        self.crepe = StreamingCrepe(crepe, device=device)
        self.n_state = whisper.n_state
        self.emitted = 0          # 320-hop frames emitted so far
        self.total = 0
        self._hz_hist: dict[int, float] = {}   # decoded Hz per 320-hop frame

    def _emit(self, n_emit: int):
        """Features of the 320-hop frames [self.emitted, n_emit)."""
        lo, hi = self.emitted, n_emit
        if hi <= lo:
            return (np.zeros((0, self.n_state), np.float32),
                    np.zeros((0, VEC_DIM), np.float32), np.zeros(0, np.float32))
        ppg = self.whisper.frames(lo, hi)
        vec = self.hubert.frames(lo, hi)

        # pitch: decode [lo, head]; frames emitted earlier keep their values,
        # so the filter context already used does not change
        path = self.crepe.decode(lo, self.crepe.head + 1)
        hz_all = cents_to_frequency(bins_to_cents(path)).astype(np.float32)
        for i, f in enumerate(range(lo, self.crepe.head + 1)):
            self._hz_hist[f] = float(hz_all[i])
        # the centred mean-5 at 100 fps over [2*lo, 2*hi) needs the 320-hop
        # frames [lo-1, hi], all in the history (the lag keeps head >= hi)
        ctx_lo = max(0, lo - 1)
        ctx_hi = min(self.crepe.head, hi)
        raw = np.asarray([self._hz_hist[f] for f in range(ctx_lo, ctx_hi + 1)], np.float64)
        filt = nan_mean_filter(np.repeat(raw, 2), 5)
        # inner slices see all +-2 taps; only the stream's start (lo == 0)
        # takes the filter's edge, as offline
        off = 2 * (lo - ctx_lo)
        if lo > 0:
            assert off >= 2
        pit = np.nan_to_num(filt[off : off + 2 * (hi - lo)]).astype(np.float32)

        self.crepe.prune(lo - 2)
        for f in [f for f in self._hz_hist if f < lo - 2]:
            del self._hz_hist[f]
        self.emitted = hi
        return np.repeat(ppg, 2, axis=0), np.repeat(vec, 2, axis=0), pit

    def push(self, samples: np.ndarray):
        samples = np.asarray(samples, np.float32)
        assert len(samples) == self.block, "push exactly block_samples"
        self.total += len(samples)
        with span("svc.extract"):
            with span("svc.extract.whisper"):
                self.whisper.push(samples)
            with span("svc.extract.hubert"):
                self.hubert.push(samples)
            with span("svc.extract.crepe"):
                self.crepe.push(samples)
            with span("svc.extract.emit"):
                return self._emit(self.total // HOP - self.lag)

    def flush(self):
        """Emit the lag tail (the offline right zero padding; the final
        backtrace is the offline Viterbi path)."""
        with span("svc.extract"):
            with span("svc.extract.crepe"):
                self.crepe.finish()
            with span("svc.extract.emit"):
                return self._emit(self.total // HOP)
