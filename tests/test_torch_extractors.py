"""The port's feature extractors against the JAX package's, at small widths:
whisper (log-mel, the encoder, pred_ppg's masked tail), HuBERT-soft
(pred_vec's masked tail), CREPE (probabilities, the Viterbi decode, F0 with
the same numpy random stream), crepe_extras, the LSTM speaker encoder, and
the loaders of the reference checkpoint layouts. Weights go JAX -> port
through the port's `from_jax_*` and port -> JAX through the JAX package's
converters on the port's `state_dict()`. Each tolerance is stated beside
its assert."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models import crepe as jcrepe
from whisper_vits_svc_tpu.models import crepe_extras as jextras
from whisper_vits_svc_tpu.models import hubert as jhubert
from whisper_vits_svc_tpu.models import speaker_encoder as jspk
from whisper_vits_svc_tpu.models import whisper as jwhisper
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models import crepe as pcrepe
from whisper_vits_svc_tpu_torch.models import crepe_extras as pextras
from whisper_vits_svc_tpu_torch.models import hubert as phubert
from whisper_vits_svc_tpu_torch.models import speaker_encoder as pspk
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper

SR = 16000


def _perturbed(tree, seed: int, scale: float):
    """A JAX param tree with every leaf moved by scale * N(0, 1), so that
    zero- and one-initialised leaves (biases, norms) take part."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _max_leaf_diff(a, b) -> float:
    return max(jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.abs(np.asarray(x) - np.asarray(y)).max()), a, b)))


# ---------------------------------------------------------------- whisper


@pytest.fixture(scope="module")
def whisper_pair():
    """n_state 64, 4 heads, 2 layers: the JAX encoder and the port with the
    same weights (JAX -> port)."""
    jm = jwhisper.WhisperEncoder(n_mels=80, n_ctx=1500, n_state=64, n_head=4, n_layer=2)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1500, 80)))["params"],
                        0, 0.02)
    pm = pwhisper.WhisperEncoder(n_state=64, n_head=4, n_layer=2).eval()
    pm.load_state_dict(convert.from_jax_whisper(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("masked", [False, True])
def test_log_mel_spectrogram_matches_jax(masked):
    """Two rows; the second holds a loud tone after 1.3 s, which n_samples
    marks as padding: the floor then comes from the real frames only.
    The power comes from float32 DFT matmuls summed in other orders, and
    bins beside the loud tone lose digits to cancellation: 1e-4 (the JAX
    package holds its log-mel to torch.stft at 1e-4 too)."""
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, 3 * SR)) * 0.2).astype(np.float32)
    tail = np.arange(3 * SR - int(1.3 * SR))
    audio[1, int(1.3 * SR):] = 0.9 * np.sin(2 * np.pi * 440 * tail / SR)
    n = np.array([3 * SR, int(1.3 * SR)], np.int64) if masked else None
    ref = np.asarray(jwhisper.log_mel_spectrogram(
        jnp.asarray(audio), None if n is None else jnp.asarray(n, jnp.int32)))
    got = pwhisper.log_mel_spectrogram(
        torch.from_numpy(audio), None if n is None else torch.from_numpy(n)).numpy()
    assert got.shape == ref.shape == (2, 300, 80)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    if masked:  # the floor differs from the unmasked one on the second row
        plain = pwhisper.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
        assert np.abs(plain[1] - got[1]).max() > 0.1
        np.testing.assert_array_equal(plain[0], got[0])


def test_pred_ppg_masked_tail_matches_jax(whisper_pair):
    """15 s + 5 s: one full window and a zero-padded, masked tail in one
    call, against JAX's masked result (its last <= 2 tail frames deviate
    from a natural-length run, on both sides alike). rng=None on both
    sides. 24 float32 matmul layers summed in other orders: 1e-4."""
    jm, params, pm = whisper_pair
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(20 * SR) * 0.2).astype(np.float32)
    ref = jwhisper.pred_ppg(jm, params, audio, rng=None)
    got = pwhisper.pred_ppg(pm, audio, rng=None)
    assert got.shape == ref.shape == (1000, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the mel noise is drawn from the generator: the same seed, the same PPG
    noisy = pwhisper.pred_ppg(pm, audio, rng=torch.Generator().manual_seed(0))
    again = pwhisper.pred_ppg(pm, audio, rng=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(noisy, again)
    assert np.abs(noisy - got).max() > 1e-3


def test_whisper_port_weights_into_jax(whisper_pair):
    """port -> JAX: the JAX converter reads the port's state_dict (under the
    reference's "encoder." prefix) back into the tree it came from, and the
    JAX encoder on it gives the port's PPG (1e-4, as above)."""
    jm, params, pm = whisper_pair
    sd = {f"encoder.{k}": v for k, v in pm.state_dict().items()}
    back = jwhisper.convert_encoder(sd, n_layer=2)
    assert _max_leaf_diff(back, params) == 0.0
    audio = (np.random.default_rng(3).standard_normal(4 * SR) * 0.2).astype(np.float32)
    np.testing.assert_allclose(pwhisper.pred_ppg(pm, audio),
                               jwhisper.pred_ppg(jm, back, audio), rtol=1e-4, atol=1e-4)


def test_load_whisper_encoder_reference_layout(tmp_path):
    """A reference-layout `.pt`: {dims, model_state_dict} with 4 encoder
    blocks stored in float16, a float16 positional_embedding and decoder
    keys. The port keeps 4 - 4 // 4 = 3 blocks, casts to float32, ignores
    the stored positional_embedding and the decoder, and gives the JAX
    loader's PPG on the same file (1e-4)."""
    torch.manual_seed(0)
    n_state, n_layer = 32, 4
    ref = pwhisper.WhisperEncoder(n_state=n_state, n_head=4, n_layer=n_layer)
    msd = {f"encoder.{k}": (v * 3).half() for k, v in ref.state_dict().items()}
    msd["encoder.positional_embedding"] = torch.from_numpy(
        pwhisper.sinusoids(1500, n_state)).half()
    msd["decoder.token_embedding.weight"] = torch.zeros(10, n_state).half()
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=n_state, n_audio_head=4,
                n_audio_layer=n_layer, n_vocab=10, n_text_ctx=8, n_text_state=n_state,
                n_text_head=4, n_text_layer=1)
    path = str(tmp_path / "large-v2.pt")
    torch.save({"dims": dims, "model_state_dict": msd}, path)
    pm = pwhisper.load_whisper_encoder(path, device="cpu")
    assert len(pm.blocks) == 3
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    torch.testing.assert_close(pm.blocks[2].mlp[0].weight, msd["encoder.blocks.2.mlp.0.weight"]
                               .float(), rtol=0, atol=0)
    jm, jp = jwhisper.load_whisper_encoder(path)
    audio = (np.random.default_rng(4).standard_normal(2 * SR) * 0.2).astype(np.float32)
    np.testing.assert_allclose(pwhisper.pred_ppg(pm, audio), jwhisper.pred_ppg(jm, jp, audio),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- hubert


@pytest.fixture(scope="module")
def hubert_pair():
    """2 transformer layers; JAX -> port (convert_hubert reads exactly 12)."""
    jm = jhubert.HubertSoft(n_layers=2)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 2 * SR)))["params"],
                        1, 0.05)
    pm = phubert.HubertSoft(n_layers=2).eval()
    pm.load_state_dict(convert.from_jax_hubert(params), strict=True)
    return jm, params, pm


def test_pred_vec_masked_tail_matches_jax(hubert_pair):
    """2 s windows over 3.13 s: a full window and a masked tail in one call.
    Against JAX at rtol 1e-4 / atol 1e-5, the tolerance the JAX package pins
    its own masked tail to; and the port's masked tail against its own
    natural-length run at the same tolerance."""
    jm, params, pm = hubert_pair
    audio = (np.random.default_rng(5).standard_normal(int(3.13 * SR)) * 0.2).astype(np.float32)
    ref = jhubert.pred_vec(jm, params, audio, window_seconds=2)
    got = phubert.pred_vec(pm, audio, window_seconds=2)
    n_full = phubert.hubert_num_frames(2 * SR)
    assert got.shape == ref.shape == (n_full + phubert.hubert_num_frames(len(audio) - 2 * SR),
                                      256)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        nat = pm(torch.from_numpy(audio[2 * SR:])[None])[0].numpy()
    np.testing.assert_allclose(got[n_full:], nat, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [16000, 16001, 12345])
def test_hubert_num_frames(n, hubert_pair):
    assert phubert.hubert_num_frames(n) == jhubert.hubert_num_frames(n)
    with torch.no_grad():
        out = hubert_pair[2](torch.zeros(1, n))
    assert out.shape == (1, phubert.hubert_num_frames(n), 256)


def test_masked_instance_norm_matches_unmasked_on_real_frames():
    """The masked statistics of a zero-padded row equal the plain
    statistics of its real frames (float32: 1e-5)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 8, 50)).astype(np.float32))
    w, b = torch.rand(8) + 0.5, torch.randn(8)
    pad = x.clone()
    pad[1, :, 30:] = 0.0
    mask = torch.arange(50)[None, :] < torch.tensor([50, 30])[:, None]
    got = phubert.masked_instance_norm(pad, w, b, mask)
    torch.testing.assert_close(got[0], phubert.masked_instance_norm(x[:1], w, b)[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1, :, :30],
                               phubert.masked_instance_norm(x[1:, :, :30], w, b)[0],
                               rtol=1e-5, atol=1e-5)


def test_load_hubert_soft_reference_layout(tmp_path):
    """A state_dict under "module." with the pre-training-only keys loads
    with weights_only=True, strictly, into the layer count it holds."""
    torch.manual_seed(1)
    ref = phubert.HubertSoft(n_layers=2)
    sd = {f"module.{k}": v for k, v in ref.state_dict().items()}
    sd["module.masked_spec_embed"] = torch.rand(768)
    sd["module.label_embedding.weight"] = torch.randn(100, 256)
    path = str(tmp_path / "hubert-soft.pt")
    torch.save(sd, path)
    pm = phubert.load_hubert_soft(path, device="cpu")
    assert len(pm.encoder.layers) == 2
    for k, v in ref.state_dict().items():
        assert torch.equal(pm.state_dict()[k], v), k


# ---------------------------------------------------------------- crepe


@pytest.fixture(scope="module")
def crepe_pair():
    """CREPE "tiny": a reference-layout state_dict (BatchNorm with running
    statistics) in the port, carried port -> JAX by convert_crepe, and the
    JAX tree carried back JAX -> port by from_jax_crepe."""
    torch.manual_seed(2)
    pm = pcrepe.Crepe("tiny").eval()
    with torch.no_grad():
        for i in range(1, 7):
            bn = getattr(pm, f"conv{i}_BN")
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.1)
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 2.0)
        pm.classifier.weight.mul_(8.0)  # spread the sigmoids so the path moves
    params = jcrepe.convert_crepe(pm.state_dict())
    back = pcrepe.Crepe("tiny").eval()
    back.load_state_dict(convert.from_jax_crepe(params), strict=True)
    return jcrepe.Crepe("tiny"), params, pm, back


def _voice(seconds: float, seed: int) -> np.ndarray:
    """A gliding tone with noise, silence in the middle."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    f0 = np.linspace(150.0, 400.0, n)
    audio = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR) + 0.01 * rng.standard_normal(n)
    audio[n // 3 : n // 2] *= 0.01
    return audio.astype(np.float32)


def test_crepe_probabilities_both_directions(crepe_pair):
    """Probabilities of normalised frames: the port with the reference
    BatchNorm, the port with the folded JAX tree, and JAX, within 1e-5
    (float32 convs summed in other orders, then a sigmoid)."""
    jm, params, pm, back = crepe_pair
    frames = pcrepe.frame_audio(_voice(0.5, 7), 160)
    ref = np.asarray(jcrepe._crepe_program(jm, params, jnp.asarray(frames)))
    got = pcrepe.crepe_probabilities(pm, frames, batch_size=16)
    got_back = pcrepe.crepe_probabilities(back, frames, batch_size=64)
    assert got.shape == ref.shape == (len(frames), 360)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_back, ref, rtol=1e-5, atol=1e-5)
    # the folded BatchNorm carried back: running var 1 - eps, eps added, is 1
    assert float(back.conv3_BN.running_var[0] + back.conv3_BN.eps) == 1.0


def test_crepe_conv1d_form_equals_torchcrepe_conv2d(crepe_pair):
    """The port runs the reference's (K, 1) Conv2d kernels as Conv1d; the
    torchcrepe forward (Conv2d modules, eval BatchNorm, (2, 1) max-pool,
    the (h, c) flatten) on the same weights gives the same probabilities
    (float32 sums in other orders: 1e-6)."""
    pm = crepe_pair[2]
    frames = pcrepe.normalize_frames(torch.from_numpy(pcrepe.frame_audio(_voice(0.3, 13), 160)))
    with torch.no_grad():
        x = frames[:, None, :, None]
        for i in range(1, 7):
            x = torch.nn.functional.pad(x, (0, 0, 254, 254) if i == 1 else (0, 0, 31, 32))
            x = getattr(pm, f"conv{i}_BN")(torch.relu(getattr(pm, f"conv{i}")(x)))
            x = torch.nn.functional.max_pool2d(x, (2, 1), (2, 1))
        ref = torch.sigmoid(pm.classifier(x.permute(0, 2, 1, 3).reshape(len(x), -1)))
        torch.testing.assert_close(pm(frames), ref, rtol=0, atol=1e-6)


def test_crepe_predict_and_f0_match_jax(crepe_pair):
    """predict at hop 160 with a dither stream, compute_f0 and
    compute_f0_sing with default_rng(0) on both sides: the same Viterbi
    paths, so F0 within 1e-5 Hz and periodicity within 1e-5."""
    jm, params, pm, _ = crepe_pair
    audio = _voice(1.2, 8)
    ref_p, ref_q = jcrepe.predict(jm, params, audio, dither_rng=np.random.default_rng(3))
    got_p, got_q = pcrepe.predict(pm, audio, dither_rng=np.random.default_rng(3))
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_q, ref_q, rtol=0, atol=1e-5)
    for fn in ("compute_f0", "compute_f0_sing"):
        ref = getattr(jcrepe, fn)(jm, params, audio, np.random.default_rng(0))
        got = getattr(pcrepe, fn)(pm, audio, np.random.default_rng(0))
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T", [1, 5, 255, 256, 257])
def test_viterbi_decode_matches_jax(T):
    """Random softmaxed probabilities (float32, as predict hands them on):
    the same path as JAX's bucketed trellis, index for index; T == 1 is
    the argmax of the first step."""
    rng = np.random.default_rng(T)
    logits = rng.standard_normal((T, pcrepe.PITCH_BINS)).astype(np.float32) * 3
    ex = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = ex / ex.sum(axis=1, keepdims=True)
    got = pcrepe.viterbi_decode(probs, device="cpu")
    np.testing.assert_array_equal(got, jcrepe.viterbi_decode(probs))
    if T == 1:
        assert got[0] == int(np.argmax(probs[0]))


def test_viterbi_takes_the_first_index_on_ties():
    """Flat probabilities tie every path: the first argmax everywhere,
    bin 0, as JAX's argmax gives."""
    probs = np.full((6, pcrepe.PITCH_BINS), 1.0 / pcrepe.PITCH_BINS, np.float32)
    np.testing.assert_array_equal(pcrepe.viterbi_decode(probs, device="cpu"),
                                  jcrepe.viterbi_decode(probs))
    np.testing.assert_array_equal(pcrepe.viterbi_decode(probs, device="cpu"),
                                  np.zeros(6, np.int64))


@pytest.mark.parametrize("win", [3, 5, 7])
def test_nan_filters_match_jax(win):
    rng = np.random.default_rng(win)
    x = rng.uniform(100, 300, 60)
    x[[0, 7, 8, 9, 30, 59]] = np.nan
    x[40:52] = np.nan
    np.testing.assert_array_equal(pcrepe.nan_mean_filter(x, win), jcrepe.nan_mean_filter(x, win))
    np.testing.assert_array_equal(pcrepe.nan_median_filter(x, win),
                                  jcrepe.nan_median_filter(x, win))


def test_cents_and_bins_match_jax():
    bins = np.arange(0, 360, 7)
    np.testing.assert_array_equal(pcrepe.bins_to_cents(bins), jcrepe.bins_to_cents(bins))
    np.testing.assert_array_equal(
        pcrepe.bins_to_cents(bins, np.random.default_rng(1)),
        jcrepe.bins_to_cents(bins, np.random.default_rng(1)))
    freqs = np.array([32.7, 50.0, 220.0, 1000.0, 1975.5])
    for q in (np.floor, np.ceil):
        np.testing.assert_array_equal(pcrepe.frequency_to_bins(freqs, q),
                                      jcrepe.frequency_to_bins(freqs, q))
    np.testing.assert_array_equal(pcrepe.cents_to_frequency(pcrepe.bins_to_cents(bins)),
                                  jcrepe.cents_to_frequency(jcrepe.bins_to_cents(bins)))
    np.testing.assert_array_equal(pcrepe._transition_matrix(), jcrepe._transition_matrix())


def test_crepe_extras_match_jax():
    """U/V thresholds, A-weighting, the loudness (float32 STFT: 1e-4 dB)
    and the argmax decoders."""
    rng = np.random.default_rng(9)
    pitch = rng.uniform(100, 400, 200)
    peri = rng.uniform(0, 1, 200)
    np.testing.assert_array_equal(pextras.At(0.4)(pitch, peri), jextras.At(0.4)(pitch, peri))
    for kw in ({}, {"return_threshold": True}):
        got, ref = pextras.Hysteresis(**kw)(pitch, peri), jextras.Hysteresis(**kw)(pitch, peri)
        for g, r in zip(got if kw else [got], ref if kw else [ref]):
            np.testing.assert_array_equal(g, r)
    freqs = np.linspace(0, 8000, 513)
    np.testing.assert_array_equal(pextras.a_weighting_db(freqs), jextras.a_weighting_db(freqs))
    audio = _voice(0.5, 10)
    np.testing.assert_allclose(pextras.a_weighted_loudness(audio),
                               jextras.a_weighted_loudness(audio), rtol=0, atol=1e-4)
    probs = rng.random((40, 360))
    for fn in ("argmax_decode", "weighted_argmax_decode"):
        for g, r in zip(getattr(pextras, fn)(probs), getattr(jextras, fn)(probs)):
            np.testing.assert_array_equal(g, r)


def test_load_crepe_reads_the_capacity(tmp_path, crepe_pair):
    path = str(tmp_path / "tiny.pth")
    torch.save(crepe_pair[2].state_dict(), path)
    loaded = pcrepe.load_crepe(path, device="cpu")
    assert loaded.in_features == 256
    for k, v in crepe_pair[2].state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ---------------------------------------------------------------- speaker


@pytest.fixture(scope="module")
def speaker_pair():
    """LSTM 32 -> 16, 3 layers; JAX -> port."""
    jm = jspk.LSTMSpeakerEncoder(proj_dim=16, lstm_dim=32, num_layers=3)
    params = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 80)))["params"], 3, 0.05)
    pm = pspk.LSTMSpeakerEncoder(proj_dim=16, lstm_dim=32, num_layers=3).eval()
    pm.load_state_dict(convert.from_jax_speaker_encoder(params), strict=True)
    return jm, params, pm


def test_compute_embedding_both_directions(speaker_pair):
    """compute_embedding of a 4 s voice with trimmed silence: the port
    against JAX, and JAX on the tree convert_speaker_encoder reads back
    from the port's state_dict (float32 LSTM, 250 steps: 1e-5)."""
    jm, params, pm = speaker_pair
    audio = np.concatenate([np.zeros(SR // 2, np.float32), _voice(4.0, 11)])
    ref = jspk.compute_embedding(jm, params, audio)
    got = pspk.compute_embedding(pm, audio)
    assert got.shape == ref.shape == (16,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    back = jspk.convert_speaker_encoder(pm.state_dict())
    assert _max_leaf_diff(back, params) == 0.0
    np.testing.assert_array_equal(pspk.trim_silence(audio), jspk.trim_silence(audio))
    np.testing.assert_allclose(pspk.speaker_melspectrogram(audio),
                               jspk.speaker_melspectrogram(audio), rtol=0, atol=1e-5)


def test_speaker_lengths_gather_natural_rows(speaker_pair):
    """Right-zero-padded rows with lengths give the natural-length rows'
    d-vectors (the LSTM is causal; 1e-6), and embed_windows' per-utterance
    means match JAX's _spk_batch_program (1e-5)."""
    jm, params, pm = speaker_pair
    rng = np.random.default_rng(12)
    rows, lens = [], []
    pad = np.zeros((6, 32, 80), np.float32)
    for i, nf in enumerate((5, 17, 30, 5, 17, 30)):
        x = (rng.standard_normal((nf, 80)) * 0.3).astype(np.float32)
        pad[i, :nf] = x
        with torch.no_grad():
            rows.append(pm(torch.from_numpy(x)[None])[0].numpy())
        lens.append(nf)
    with torch.no_grad():
        got = pm(torch.from_numpy(pad), torch.tensor(lens)).numpy()
    np.testing.assert_allclose(got, np.stack(rows), rtol=0, atol=1e-6)
    batch = np.concatenate([pad, pad[::-1]] * 5)[:20]  # 2 utterances x 10 windows
    lengths = np.array(lens + lens[::-1], np.int64)[np.arange(20) % 12]
    ref = np.asarray(jspk._spk_batch_program(jm, params, jnp.asarray(batch), 2,
                                             jnp.asarray(lengths, jnp.int32)))
    np.testing.assert_allclose(pspk.embed_windows(pm, batch, 2, lengths), ref, rtol=0, atol=1e-5)


def test_load_speaker_encoder_reference_layout(tmp_path, speaker_pair):
    """{"model": state_dict, step} loads with weights_only=True; a file that
    pickles other objects is refused with an error naming weights_only."""
    pm = speaker_pair[2]
    path = str(tmp_path / "best_model.pth.tar")
    torch.save({"model": pm.state_dict(), "step": 10}, path)
    loaded = pspk.load_speaker_encoder(path, device="cpu")
    for k, v in pm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    bad = str(tmp_path / "pickled.pth.tar")
    torch.save({"model": pm.state_dict(), "config": argparse.Namespace(x=1)}, bad)
    with pytest.raises(ValueError, match="weights_only"):
        pspk.load_speaker_encoder(bad, device="cpu")
