"""Alternative F0 engines: vectorized YIN and pYIN (JAX
whisper_vits_svc_tpu/models/f0_alt.py; the reference vendors them in
pitch/core/{yin,pyin}.py).

  * YIN (de Cheveigne & Kawahara 2002): the difference function of every
    frame at once from an FFT autocorrelation on the device (`_cmndf`,
    torch.fft at the JAX package's nfft), then the absolute threshold and
    the parabolic refinement on the host in numpy;
  * pYIN (Mauch & Dixon 2014): YIN candidates at 100 thresholds under a
    Beta(2, 18) prior, decoded over a log-spaced pitch grid with voiced and
    unvoiced states by `_viterbi_generic`: the trellis on the device
    (float32 adds, max and the first index on ties, as the JAX lax.scan
    does), the backtrace on the host.

Both return (f0, confidence or voicing) at the hop rate, hop 160 at 16 kHz
by default. `device` is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _frame(x: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame_length)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame_length)[None, :]
    return x[idx]


def _cmndf(frames: torch.Tensor, lag_max: int) -> torch.Tensor:
    """Cumulative mean-normalized difference of every frame, float32 on
    frames' device. [T, N] -> [T, lag_max + 1]."""
    t, n = frames.shape
    dev = frames.device
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    spec = torch.fft.rfft(frames, nfft)
    ac = torch.fft.irfft(spec * torch.conj(spec), nfft)[:, : lag_max + 1]  # [T, L+1]
    # energy terms e(tau) = sum_{j<N-tau} x_j^2 ; e'(tau) = sum_{j>=tau} x_j^2
    csum = torch.cumsum(frames.square(), dim=1)
    total = csum[:, -1:]
    head = torch.cat([torch.zeros_like(total), csum], dim=1)
    tau = torch.arange(lag_max + 1, device=dev)
    d = (head[:, n - tau] + (total - head[:, tau]) - 2.0 * ac).clamp_min(0.0)
    # d(tau) * tau / cumsum(d)(tau), d(0) = 1; a silent frame (d ~ 0
    # everywhere) reads 1, so that no threshold fires there
    dcum = torch.cumsum(d[:, 1:], dim=1)
    lags = torch.arange(1, lag_max + 1, dtype=torch.float32, device=dev)
    cmndf = torch.where(dcum > 1e-9, d[:, 1:] * lags / dcum.clamp_min(1e-12),
                        torch.ones((), device=dev))
    return torch.cat([torch.ones((t, 1), device=dev), cmndf], dim=1)


def cmndf(x: np.ndarray, frame_length: int, hop: int, lag_max: int,
          device: str | torch.device | None = "cuda") -> np.ndarray:
    """Frames of x [T, frame_length] -> their CMNDF [T, lag_max + 1], float32."""
    dev = resolve_device(device)
    frames = torch.from_numpy(_frame(np.asarray(x, np.float32), frame_length, hop))
    return _cmndf(frames.to(dev), lag_max).cpu().numpy()


def _parabolic_refine(cmndf: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """Sub-sample lag refinement around the chosen minimum."""
    T, L = cmndf.shape
    t0 = np.clip(tau - 1, 0, L - 1)
    t2 = np.clip(tau + 1, 0, L - 1)
    y0 = cmndf[np.arange(T), t0]
    y1 = cmndf[np.arange(T), tau]
    y2 = cmndf[np.arange(T), t2]
    denom = y0 - 2 * y1 + y2
    offset = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    return tau + np.clip(offset, -1.0, 1.0)


def _absolute_threshold(region: np.ndarray, threshold: float) -> np.ndarray:
    """YIN absolute thresholding, vectorized over frames: the first lag with
    cmndf < threshold, then downhill to the local minimum; the global argmin
    where nothing dips below the threshold."""
    T, L = region.shape
    below = region < threshold
    has_below = below.any(axis=1)
    first = np.argmax(below, axis=1)
    nxt = np.concatenate([region[:, 1:], np.full((T, 1), np.inf)], axis=1)
    is_local_min = nxt >= region
    idxs = np.arange(L)[None, :]
    candidates = (idxs >= first[:, None]) & is_local_min
    walked = np.argmax(candidates, axis=1)
    return np.where(has_below, walked, np.argmin(region, axis=1))


def yin(x: np.ndarray, fs: int = 16000, frame_length: int = 2048, hop: int = 160,
        fmin: float = 55.0, fmax: float = 1000.0, threshold: float = 0.15,
        device: str | torch.device | None = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """-> (f0 [T], aperiodicity-confidence [T]); f0 = 0 where no valid lag."""
    lag_min = max(int(fs / fmax), 2)
    lag_max = min(int(fs / fmin), frame_length - 1)
    c = cmndf(x, frame_length, hop, lag_max, device)
    T = len(c)
    region = c[:, lag_min : lag_max + 1]
    best = _absolute_threshold(region, threshold) + lag_min
    tau = _parabolic_refine(c, best)
    f0 = fs / np.maximum(tau, 1e-6)
    conf = 1.0 - c[np.arange(T), best]
    f0 = np.where((f0 >= fmin) & (f0 <= fmax), f0, 0.0)
    return f0.astype(np.float32), conf.astype(np.float32)


def _beta_weights(thresholds: np.ndarray, a: float = 2.0, b: float = 18.0) -> np.ndarray:
    """Beta(2, 18) prior over YIN thresholds (pYIN paper / pitch/core/pyin.py)."""
    from scipy.stats import beta as beta_distr

    pdf = beta_distr.pdf(thresholds, a, b)
    return pdf / pdf.sum()


def pyin(x: np.ndarray, fs: int = 16000, frame_length: int = 2048, hop: int = 160,
         fmin: float = 55.0, fmax: float = 1000.0, n_thresholds: int = 100,
         bins_per_semitone: int = 10, switch_prob: float = 0.01,
         device: str | torch.device | None = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Probabilistic YIN -> (f0 [T], voiced probability [T]): candidate lags
    of every threshold level weighted by the beta prior, decoded over a
    log-spaced pitch grid with a triangular-transition HMM."""
    lag_min = max(int(fs / fmax), 2)
    lag_max = min(int(fs / fmin), frame_length - 1)
    c = cmndf(x, frame_length, hop, lag_max, device)
    T = len(c)

    thresholds = np.linspace(0.01, 1.0, n_thresholds, endpoint=False)
    weights = _beta_weights(thresholds)
    n_bins = int(np.ceil(12 * bins_per_semitone * np.log2(fmax / fmin))) + 1
    grid_hz = fmin * 2 ** (np.arange(n_bins) / (12 * bins_per_semitone))

    region = c[:, lag_min : lag_max + 1]  # [T, L]
    obs = np.zeros((T, n_bins), np.float64)
    argmin_lag = np.argmin(region, axis=1) + lag_min
    for thr, w in zip(thresholds, weights):
        below = region < thr
        has = below.any(axis=1)
        lag = np.where(has, _absolute_threshold(region, thr) + lag_min, argmin_lag)
        f0_cand = fs / np.maximum(_parabolic_refine(c, lag), 1e-6)
        valid = (f0_cand >= fmin) & (f0_cand <= fmax)
        bin_idx = np.clip(
            np.round(12 * bins_per_semitone * np.log2(np.maximum(f0_cand, fmin) / fmin)),
            0, n_bins - 1,
        ).astype(np.int64)
        # voiced probability mass only where the threshold fired
        contrib = w * np.where(has & valid, 1.0, 0.0)
        np.add.at(obs, (np.arange(T), bin_idx), contrib)

    voiced_prob = obs.sum(axis=1)
    # states: [voiced bins ; unvoiced bins]
    eps = 1e-10
    observation = np.concatenate(
        [obs + eps, ((1.0 - voiced_prob) / n_bins)[:, None].repeat(n_bins, 1) + eps], axis=1)
    max_jump = bins_per_semitone * 4
    xx, yy = np.meshgrid(np.arange(n_bins), np.arange(n_bins))
    tri = np.maximum(max_jump - np.abs(xx - yy), 0).astype(np.float64)
    tri /= tri.sum(axis=1, keepdims=True)
    A = np.block([
        [(1 - switch_prob) * tri, switch_prob * tri],
        [switch_prob * tri, (1 - switch_prob) * tri],
    ])

    path = _viterbi_generic(observation, A, device)
    voiced = path < n_bins
    f0 = np.where(voiced, grid_hz[path % n_bins], 0.0)
    return f0.astype(np.float32), voiced_prob.astype(np.float32)


def viterbi_trellis(log_obs: torch.Tensor, log_trans: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, S] log observations and [S, S] log transitions, float32 on one
    device -> (the last step's values [S], backpointers [T - 1, S]).

    One step: scores[from, to] = value[from] + log_trans[from, to]; the
    pointer is the first argmax over `from` (torch.argmax's tie rule, on the
    card as on the CPU), the value the max plus the observation. The start
    is log_obs[0] + log(1 / S) in float32."""
    dev = log_obs.device
    s = log_obs.shape[1]
    value = log_obs[0] + torch.log(torch.tensor(1.0 / s, dtype=torch.float32, device=dev))
    ptrs = torch.empty((max(len(log_obs) - 1, 0), s), dtype=torch.int64, device=dev)
    for t in range(1, len(log_obs)):
        scores = value[:, None] + log_trans
        ptrs[t - 1] = scores.argmax(dim=0)
        value = scores.amax(dim=0) + log_obs[t]
    return value, ptrs


def _viterbi_generic(obs: np.ndarray, transition: np.ndarray,
                     device: str | torch.device | None = "cuda") -> np.ndarray:
    """Most likely state path [T] of `obs` [T, S] under `transition` [S, S]:
    both floored at 1e-30, the observations' log taken in float64 on the
    host and the transitions' in float32 on the device, as the JAX package
    takes them; the trellis on the device, the backtrace on the host."""
    dev = resolve_device(device)
    log_obs = torch.from_numpy(np.log(np.maximum(obs, 1e-30)).astype(np.float32)).to(dev)
    log_t = torch.log(torch.from_numpy(np.maximum(transition, 1e-30).astype(np.float32)).to(dev))
    final, ptrs = viterbi_trellis(log_obs, log_t)
    final, ptrs = final.cpu().numpy(), ptrs.cpu().numpy()
    T = len(obs)
    path = np.empty(T, np.int64)
    path[-1] = int(final.argmax())
    for t in range(T - 2, -1, -1):
        path[t] = ptrs[t, path[t + 1]]
    return path
