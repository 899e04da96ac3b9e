"""The port's F0 engines against the JAX package's on the tone signals of
tests/test_aux_components.py, on the CPU: yin and pyin (the CMNDF from
torch.fft against jnp.fft, the Viterbi trellis), salience (the complex
STFT, the harmonic product, the Viterbi), swipe (the STFT magnitudes) and
the numpy copies of dio and praat (bitwise)."""

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.models import dio as jdio
from whisper_vits_svc_tpu.models import f0_alt as jf0_alt
from whisper_vits_svc_tpu.models import praat as jpraat
from whisper_vits_svc_tpu.models import salience as jsalience
from whisper_vits_svc_tpu.models import swipe as jswipe
from whisper_vits_svc_tpu_torch.models import dio, f0_alt, praat, salience, swipe

SR = 16000
TONES = (110.0, 220.0, 440.0)


def _sine(f0, seconds=1.0, amp=0.5):
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _harmonic(f0, n_harm):
    t = np.arange(SR) / SR
    x = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, n_harm + 1))
    return (x * 0.2).astype(np.float32)


def _tone_then_silence():
    return np.concatenate([_sine(220.0, seconds=0.5), np.zeros(8000, np.float32)])


def _cents(a, b):
    return np.abs(1200.0 * np.log2(a / b))


@pytest.mark.parametrize("f_true", TONES)
def test_cmndf_matches_jax(f_true):
    """The CMNDF of every frame: torch.fft in float32 against XLA's FFT.
    The autocorrelation holds sums of 2048 products (up to ~260), rounded
    in other orders, and the CMNDF divides its differences: 1e-4 absolute
    and relative (measured up to 6.7e-5, 4.6e-5 relative)."""
    import jax.numpy as jnp

    x = _sine(f_true) + 0.01 * np.random.default_rng(0).standard_normal(SR).astype(np.float32)
    frames = jf0_alt._frame(x, 2048, 160)
    ref = np.asarray(jf0_alt._cmndf(jnp.asarray(frames), 290))
    got = f0_alt.cmndf(x, 2048, 160, 290, device="cpu")
    assert got.shape == ref.shape == (len(frames), 291)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("f_true", TONES)
def test_yin_matches_jax_on_tones(f_true):
    """Every frame of a pure tone decides clearly: the same voicing, F0
    within 0.01 cent, the confidence within 2e-5."""
    f0, conf = f0_alt.yin(_sine(f_true), fs=SR, hop=160, device="cpu")
    jf0, jconf = jf0_alt.yin(_sine(f_true), fs=SR, hop=160)
    np.testing.assert_array_equal(f0 > 0, jf0 > 0)
    assert (f0 > 0).mean() > 0.8
    assert _cents(f0[f0 > 0], jf0[jf0 > 0]).max() < 0.01
    np.testing.assert_allclose(conf, jconf, atol=2e-5)


def test_pyin_matches_jax_on_tone_with_silence():
    """The Viterbi path over 2 x 504 states: the same voiced frames and the
    same grid bins (F0 equal), the voiced probability within 1e-6."""
    audio = _tone_then_silence()
    f0, vp = f0_alt.pyin(audio, fs=SR, hop=160, n_thresholds=30, device="cpu")
    jf0, jvp = jf0_alt.pyin(audio, fs=SR, hop=160, n_thresholds=30)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_allclose(vp, jvp, atol=1e-6)
    head = f0[: len(f0) // 3]
    assert abs(np.median(head[head > 0]) - 220.0) / 220.0 < 0.05


def test_viterbi_generic_matches_jax_with_ties():
    """Random observations with a banded transition full of ties: the same
    path (the first index on ties, float32 adds)."""
    rng = np.random.default_rng(5)
    obs = rng.random((40, 30))
    obs[5] = obs[6]  # equal rows
    idx = np.abs(np.subtract.outer(np.arange(30), np.arange(30)))
    trans = np.where(idx <= 3, 1.0, 0.01)
    np.testing.assert_array_equal(f0_alt._viterbi_generic(obs, trans, "cpu"),
                                  jf0_alt._viterbi_generic(obs, trans))


@pytest.mark.parametrize("f_true", TONES)
def test_salience_matches_jax_on_harmonic_tones(f_true):
    """The same Viterbi path over the 503 bins (F0 equal) and the salience
    within 1e-5 (the complex STFT and the harmonic product in float32)."""
    x = _harmonic(f_true, 5)
    f0, sal = salience.salience(x, fs=SR, hop=160, device="cpu")
    jf0, jsal = jsalience.salience(x, fs=SR, hop=160)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_allclose(sal, jsal, atol=1e-5)
    assert abs(np.median(f0) - f_true) / f_true < 0.01


def test_salience_wrappers_match_jax():
    """compute_f0_salience (voicing, 1 + len // hop frames) and
    compute_f0_sing_salience (hop 320 repeated, moving average): equal."""
    audio = _tone_then_silence()
    np.testing.assert_array_equal(
        salience.compute_f0_salience(audio, fs=SR, hop=160, device="cpu"),
        jsalience.compute_f0_salience(audio, fs=SR, hop=160))
    x = _harmonic(220.0, 5)
    np.testing.assert_array_equal(salience.compute_f0_sing_salience(x, fs=SR, device="cpu"),
                                  jsalience.compute_f0_sing_salience(x, fs=SR))


@pytest.mark.parametrize("f_true", TONES)
def test_swipe_matches_jax_on_harmonic_tones(f_true):
    """The same candidate on every frame, F0 within 0.01 cent, the strength
    within 1e-5 (sqrt-magnitude STFTs at 7 window sizes in float32)."""
    x = _harmonic(f_true, 7)
    f0, s = swipe.swipe(x, SR, device="cpu")
    jf0, js = jswipe.swipe(x, SR)
    np.testing.assert_array_equal(f0 > 0, jf0 > 0)
    assert _cents(f0[f0 > 0], jf0[jf0 > 0]).max() < 0.01
    np.testing.assert_allclose(s, js, atol=1e-5)
    f0_sil, _ = swipe.swipe(np.zeros(SR, np.float32), SR, device="cpu")
    assert (f0_sil == 0).all()


@pytest.mark.parametrize("make", [lambda: _harmonic(220.0, 5), _tone_then_silence],
                         ids=["tone", "tone_then_silence"])
def test_dio_and_praat_copies_bitwise(make):
    """dio and praat are numpy in both packages: the port's copies give the
    same arrays bit for bit."""
    x = make()
    np.testing.assert_array_equal(dio.compute_f0_dio(x, SR), jdio.compute_f0_dio(x, SR))
    np.testing.assert_array_equal(praat.compute_f0_mouth(x, SR), jpraat.compute_f0_mouth(x, SR))
    np.testing.assert_array_equal(praat.to_pitch_ac(x, SR), jpraat.to_pitch_ac(x, SR))


def test_engines_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = _sine(220.0, seconds=0.2)
    for call in (lambda: f0_alt.yin(x), lambda: f0_alt.pyin(x), lambda: swipe.swipe(x),
                 lambda: salience.salience(x)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
