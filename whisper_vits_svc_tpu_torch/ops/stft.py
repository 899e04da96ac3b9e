"""Matmul STFT: the three spectrogram conventions of the training losses and
the MRD discriminator (JAX whisper_vits_svc_tpu/ops/stft.py).

A spectrogram is frames[B, T_frames, n_fft] @ basis[n_fft, 2 * n_bins], the
windowed DFT basis of the JAX package ([cos | sin] columns, the window of
win_length zero-padded centered to n_fft, as torch.stft does), so the numbers
match the JAX package's. Framing is `Tensor.unfold`, whose autograd adjoint is
the overlap-add.

  * `linear_spectrogram`: the VITS linear spectrogram (reference
    vits/spectrogram.py:41-76), as `mel_spectrogram` before the mel
    projection, eps 1e-6; validation's spectrogram panels use it;
  * `mel_spectrogram`: TacotronSTFT (reference vits_extend/stft.py:76-110):
    reflect pre-pad (n_fft - hop)/2, center=False, hann, eps 1e-9 under the
    sqrt, log of the mel clamped at 1e-5;
  * `stft_loss_magnitude`: the MR-STFT loss (vits_extend/stft_loss.py:12-29):
    center=True with reflect padding, hann, power clamped at 1e-7;
  * `mrd_magnitude`: the MRD front end (vits_decoder/mrd.py:39-46): reflect
    pre-pad, center=False, NO window (rectangular ones(win_length)) and no eps
    under the sqrt; both quirks are the reference's.

Beside them the complex STFT (`stft_complex`, the salience F0 engine's
front end), its inverse (`istft`, torch.istft semantics: per-frame inverse
rDFT as one product, window, overlap-add, division by the overlap-added
squared window, `center` trim), `frame_signal`, `dynamic_range_compression`
and `spec_to_mel`. Every DFT is a matrix product, as in the JAX package.

Outputs are [B, frames, bins]. Float64 inputs stay float64 (the bases are
cast to them); any other input is computed in float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank

_device_cache: dict = {}


@lru_cache(maxsize=None)
def _windowed_dft(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """[n_fft, 2*n_bins] windowed DFT basis: [cos | sin] columns, float32."""
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft})")
    n_bins = n_fft // 2 + 1
    w_full = _window(n_fft, win_length, window)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * n / n_fft
    basis = np.concatenate([np.cos(phase), np.sin(phase)], axis=1)
    return (w_full[:, None] * basis).astype(np.float32)


def _tracing() -> bool:
    c = torch.compiler
    return c.is_compiling() or bool(getattr(c, "is_exporting", lambda: False)())


def _on(device: torch.device, key: tuple, make, dtype=torch.float32) -> torch.Tensor:
    """A constant built once per device and dtype (the n_fft=4096 basis is
    67 MB in float32), outside inference mode, so that a constant first made
    under torch.inference_mode (preprocessing, extraction) still serves a
    later training step's autograd. Under torch.export's tracing the
    constant is built for the trace and not cached: the trace's tensors are
    fake, and a later eager call must not read them."""
    k = (str(device), dtype) + key
    if k not in _device_cache:
        with torch.inference_mode(False):
            t = torch.from_numpy(make()).to(device=device, dtype=dtype)
        if _tracing():
            return t
        _device_cache[k] = t
    return _device_cache[k]


def _real(y: torch.Tensor) -> torch.Tensor:
    """float64 stays, anything else becomes float32."""
    return y if y.dtype == torch.float64 else y.float()


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., L] -> [..., 1 + (L - frame_length) // hop, frame_length], a view
    of y; autograd's adjoint is the overlap-add of the frame gradients (the
    JAX package's custom VJP, ops/stft.py:72-130)."""
    return y.unfold(-1, frame_length, hop)


def _pad(y: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    if mode == "reflect":
        return _reflect_pad(y, left, right)
    if mode == "constant":
        return F.pad(y, (left, right))
    raise ValueError(f"unknown pad mode {mode!r}")


def _reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (left, right), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def _dft(y: torch.Tensor, n_fft: int, win_length: int, window: str) -> torch.Tensor:
    return _on(y.device, ("dft", n_fft, win_length, window),
               lambda: _windowed_dft(n_fft, win_length, window), y.dtype)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int, *,
                   window: str = "hann", center: bool = False, mag_eps: float = 0.0,
                   mag_clamp: float = 0.0) -> torch.Tensor:
    """Magnitude STFT, [B, T] -> [B, frames, n_fft//2+1], float32.
    center=True reflect-pads n_fft//2 each side; mag_eps is added under the
    sqrt; mag_clamp floors the power first."""
    y = _real(y)
    if center:
        y = _reflect_pad(y, n_fft // 2, n_fft // 2)
    spec = frame_signal(y, n_fft, hop) @ _dft(y, n_fft, win_length, window)
    n_bins = n_fft // 2 + 1
    power = spec[..., :n_bins].square() + spec[..., n_bins:].square()
    if mag_clamp > 0.0:
        power = power.clamp_min(mag_clamp)
    return torch.sqrt(power + mag_eps)


def _vits_prepad(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    pad = int((n_fft - hop) / 2)
    return _reflect_pad(y, pad, pad)


def linear_spectrogram(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """VITS linear spectrogram (reference vits/spectrogram.py:41-76): reflect
    pre-pad, center=False, hann, eps 1e-6 under the sqrt.
    [B, T] -> [B, frames, n_fft//2+1]."""
    return stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                          center=False, mag_eps=1e-6)


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, hop: int,
                    win_length: int, fmin: float = 0.0, fmax: float | None = None, *,
                    mag_eps: float = 1e-9) -> torch.Tensor:
    """Log-mel spectrogram, [B, T] -> [B, frames, num_mels] (TacotronSTFT)."""
    mag = stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                         center=False, mag_eps=mag_eps)
    return spec_to_mel(mag, n_fft, num_mels, sampling_rate, fmin, fmax)


def _mel_basis(x: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
               fmin: float, fmax: float | None) -> torch.Tensor:
    return _on(x.device, ("mel", sampling_rate, n_fft, num_mels, fmin, fmax),
               lambda: np.ascontiguousarray(
                   mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax).T), x.dtype)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, min=clip_val)) (reference vits/spectrogram.py:10-16)."""
    return torch.log(x.clamp_min(clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                fmin: float, fmax: float | None) -> torch.Tensor:
    """[B, frames, bins] linear magnitude -> log-mel [B, frames, num_mels]
    (reference vits/spectrogram.py:79-90)."""
    spec = _real(spec)
    return dynamic_range_compression(
        spec @ _mel_basis(spec, n_fft, num_mels, sampling_rate, fmin, fmax))


def stft_complex(y: torch.Tensor, n_fft: int, hop: int, win_length: int, *,
                 window: str = "hann", center: bool = True,
                 pad_mode: str = "constant") -> tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT as (real, imag), each [B, frames, n_fft//2+1], with the
    phase kept (the salience F0 engine's front end; librosa's center=True
    pads n_fft//2 each side, constant padding at the salience call site)."""
    y = _real(y)
    if center:
        y = _pad(y, n_fft // 2, n_fft // 2, pad_mode)
    spec = frame_signal(y, n_fft, hop) @ _dft(y, n_fft, win_length, window)
    n_bins = n_fft // 2 + 1
    # the basis columns are [cos | sin] of +2 pi k n / N; X_k = sum x (cos - i sin)
    return spec[..., :n_bins], -spec[..., n_bins:]


def _window(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """The window of win_length zero-padded centered to n_fft, float64."""
    if window == "hann":
        n = np.arange(win_length, dtype=np.float64)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    elif window == "ones":
        w = np.ones(win_length, dtype=np.float64)
    else:
        raise ValueError(f"unknown window {window!r}")
    pad_l = (n_fft - win_length) // 2
    w_full = np.zeros(n_fft, dtype=np.float64)
    w_full[pad_l : pad_l + win_length] = w
    return w_full


@lru_cache(maxsize=None)
def _idft_basis(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """[2*n_bins, n_fft] windowed inverse-rDFT basis, float32: re @ top +
    im @ bottom is irfft(re + i im) times the window, torch.istft's
    per-frame synthesis."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * n / n_fft
    scale = np.full((n_bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    basis = np.concatenate([scale * np.cos(phase), -scale * np.sin(phase)], axis=0)
    return (basis * _window(n_fft, win_length, window)[None, :]).astype(np.float32)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, T, frame_len] -> [B, hop * (T - 1) + frame_len]."""
    b, t, frame_len = frames.shape
    length = hop * (t - 1) + frame_len
    out = F.fold(frames.transpose(1, 2), output_size=(1, length), kernel_size=(1, frame_len),
                 stride=(1, hop))
    return out.reshape(b, length)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, win_length: int, *,
          window: str = "hann", center: bool = True, length: int | None = None,
          envelope_eps: float = 1e-11) -> torch.Tensor:
    """Inverse STFT with torch.istft's semantics; (re, im) [B, frames,
    n_fft//2+1] as `stft_complex` makes them -> [B, samples]. The
    overlap-added squared window is reckoned on the host in float64, as the
    JAX package does (ops/stft.py:242-293)."""
    spec = _real(torch.cat([re, im], dim=-1))
    basis = _on(spec.device, ("idft", n_fft, win_length, window),
                lambda: _idft_basis(n_fft, win_length, window), spec.dtype)
    y = _overlap_add(spec @ basis, hop)
    n_frames = re.shape[-2]
    w_sq = _window(n_fft, win_length, window) ** 2
    env = np.zeros(hop * (n_frames - 1) + n_fft, dtype=np.float64)
    for t in range(n_frames):
        env[t * hop : t * hop + n_fft] += w_sq
    env = np.maximum(env, envelope_eps).astype(np.float32)
    y = y / torch.from_numpy(env).to(device=y.device, dtype=y.dtype)
    if center:
        # torch.istft trims n_fft//2 on the left; the right end only when no
        # length is asked for
        y = y[..., n_fft // 2 :]
        if length is None:
            y = y[..., : y.shape[-1] - n_fft // 2]
    if length is not None:
        y = y[..., :length] if y.shape[-1] >= length else F.pad(y, (0, length - y.shape[-1]))
    return y


def stft_loss_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Magnitude of the MR-STFT loss: center=True, reflect, hann, power
    clamped at 1e-7. [B, T] -> [B, frames, bins]."""
    return stft_magnitude(y, n_fft, hop, win_length, center=True, mag_clamp=1e-7)


def mrd_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Magnitude fed to the MRD: reflect pre-pad (n_fft - hop)/2,
    center=False, rectangular window, no eps. [B, T] -> [B, frames, bins]."""
    return stft_magnitude(_vits_prepad(y, n_fft, hop), n_fft, hop, win_length,
                          window="ones", center=False)
