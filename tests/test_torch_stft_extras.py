"""The rest of the port's matmul STFT (ops/stft.py) against the JAX
package's and torch's own transforms, on the CPU: the complex STFT, the
framing and its gradient, the inverse STFT, the mel projection and the
golden filterbanks (tests/golden/*.npy)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.ops import stft as jstft
from whisper_vits_svc_tpu_torch.ops import stft
from whisper_vits_svc_tpu_torch.ops.mel import mel_filterbank

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_golden_mel import VARIANTS  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _signal(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_stft_complex_matches_jax_and_torch(pad_mode):
    """The salience front end (center=True, win_length == n_fft): against
    the JAX package's stft_complex, float32 products of 512 terms summed in
    other orders, 2e-5; against torch.stft at the JAX test's tolerance."""
    n_fft, hop = 512, 160
    y = _signal(0, (1, 8000), 0.4)
    re, im = stft.stft_complex(torch.from_numpy(y), n_fft, hop, n_fft, pad_mode=pad_mode)
    jre, jim = jstft.stft_complex(y, n_fft, hop, n_fft, center=True, pad_mode=pad_mode)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-5)
    mode = "reflect" if pad_mode == "reflect" else "constant"
    yt = torch.nn.functional.pad(torch.from_numpy(y)[None], (n_fft // 2, n_fft // 2),
                                 mode=mode)[0]
    s = torch.stft(yt, n_fft, hop, n_fft, torch.hann_window(n_fft), center=False,
                   return_complex=True)
    np.testing.assert_allclose(re[0].numpy().T, s[0].real.numpy(), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(im[0].numpy().T, s[0].imag.numpy(), rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("fl,hop,L", [
    (1024, 120, 8000), (512, 50, 8000), (4096, 480, 9000),
    (1024, 320, 8640), (400, 160, 5007),
])
def test_frame_signal_and_its_gradient_match_jax(fl, hop, L):
    """The frames equal the JAX package's bit for bit; autograd's adjoint
    (the overlap-add, trailing samples no frame covers get 0) against
    jax.grad of the JAX custom VJP: sums of up to ceil(fl / hop) = 11
    terms of size ~3 in other orders, 4e-6 (measured 1.9e-6)."""
    rng = np.random.default_rng(fl + hop)
    x = rng.standard_normal((2, L)).astype(np.float32)
    w = rng.standard_normal((2, 1 + (L - fl) // hop, fl)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    frames = stft.frame_signal(xt, fl, hop)
    np.testing.assert_array_equal(frames.detach().numpy(),
                                  np.asarray(jstft.frame_signal(jnp.asarray(x), fl, hop)))
    (grad,) = torch.autograd.grad((torch.from_numpy(w) * frames).sum(), xt)
    ref = jax.grad(lambda v: jnp.sum(w * jstft.frame_signal(v, fl, hop)))(jnp.asarray(x))
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), atol=4e-6)


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 128, 512), (512, 128, 400)])
def test_istft_matches_torch_and_jax(n_fft, hop, win):
    """Against torch.istft at the JAX test's 2e-5 (tests/test_preprocess_aux.py:22-33)
    and against the JAX package's istft on the same spectrum, 1e-5."""
    y = _signal(1, (2, 8000), 0.3)
    spec = torch.stft(torch.from_numpy(y), n_fft, hop, win, torch.hann_window(win),
                      return_complex=True)
    ref = torch.istft(spec, n_fft, hop, win, torch.hann_window(win), length=y.shape[-1]).numpy()
    re, im = stft.stft_complex(torch.from_numpy(y), n_fft, hop, win, pad_mode="reflect")
    out = stft.istft(re, im, n_fft, hop, win, length=y.shape[-1]).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    jre, jim = jstft.stft_complex(y, n_fft, hop, win, center=True, pad_mode="reflect")
    jout = np.asarray(jstft.istft(jre, jim, n_fft, hop, win, center=True, length=y.shape[-1]))
    np.testing.assert_allclose(out, jout, atol=1e-5)
    # the center trim alone, and zero-padding past the end; held over the
    # signal's own samples: past them the overlap-added window falls towards
    # 0 and dividing by it magnifies the rounding of either side
    for length in (None, 9000):
        got = stft.istft(re, im, n_fft, hop, win, length=length).numpy()
        want = np.asarray(jstft.istft(jre, jim, n_fft, hop, win, length=length))
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, : y.shape[-1]], want[:, : y.shape[-1]], atol=1e-5)


def test_istft_roundtrip_identity():
    """Envelope-normalised overlap-add gives the signal back (2e-5), as the
    JAX test holds it (tests/test_preprocess_aux.py:36-40)."""
    y = _signal(2, (1, 5000), 1.0)
    re, im = stft.stft_complex(torch.from_numpy(y), 1024, 256, 1024, pad_mode="reflect")
    np.testing.assert_allclose(stft.istft(re, im, 1024, 256, 1024, length=5000).numpy(), y,
                               atol=2e-5)


@pytest.mark.parametrize("name,sr,n_fft,n_mels,fmin,fmax", VARIANTS)
def test_spec_to_mel_on_golden_filterbanks(name, sr, n_fft, n_mels, fmin, fmax):
    """The port's filterbank equals the golden bit for bit
    (tests/test_golden_mel.py); spec_to_mel and dynamic_range_compression
    against the JAX package's on the same magnitudes: products of n_fft/2
    terms then a log, 1e-5; the log alone within one float32 ulp."""
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    np.testing.assert_array_equal(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), golden)
    mag = np.abs(_signal(3, (2, 40, n_fft // 2 + 1), 1.0))
    got = stft.spec_to_mel(torch.from_numpy(mag), n_fft, n_mels, sr, fmin, fmax).numpy()
    ref = np.asarray(jstft.spec_to_mel(jnp.asarray(mag), n_fft, n_mels, sr, fmin, fmax))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    x = _signal(4, (3, 50), 1e-4)
    np.testing.assert_allclose(stft.dynamic_range_compression(torch.from_numpy(x)).numpy(),
                               np.asarray(jstft.dynamic_range_compression(jnp.asarray(x))),
                               rtol=1.2e-7, atol=0)


def test_float64_inputs_stay_float64():
    """A float64 input keeps float64 through the STFT and the mel
    projection (the bases are cast to it), and agrees with float32."""
    y = _signal(5, (1, 4000), 0.3)
    y64 = torch.from_numpy(y.astype(np.float64))
    re, im = stft.stft_complex(y64, 512, 128, 512)
    mel = stft.mel_spectrogram(y64, 1024, 80, 16000, 256, 1024)
    assert re.dtype == im.dtype == mel.dtype == torch.float64
    np.testing.assert_allclose(
        mel.numpy(), stft.mel_spectrogram(torch.from_numpy(y), 1024, 80, 16000, 256, 1024).numpy(),
        atol=1e-4)
