"""The silero VAD and the post filter, the port against the JAX package on
the CPU. Both read the same TorchScript file, written here from a small
module tree with the attribute paths of the reference blob
(vad/assets/silero_vad.jit: _model.feature_extractor.forward_basis_buffer,
adaptive_normalization.filter_, first_layer, encoder children 0-13,
decoder.rnn and decoder.decoder) and seeded random weights."""

import numpy as np
import pytest
import torch
from torch import nn

from whisper_vits_svc_tpu.infer import post as jpost
from whisper_vits_svc_tpu.models import silero_vad as jsilero
from whisper_vits_svc_tpu_torch.infer import post
from whisper_vits_svc_tpu_torch.models import convert, silero_vad

SR = 16000


class _Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, proj: bool):
        super().__init__()
        self.dw_conv = nn.Sequential(nn.Conv1d(c_in, c_in, 5, padding=2, groups=c_in))
        self.pw_conv = nn.Sequential(nn.Conv1d(c_in, c_out, 1))
        if proj:
            self.proj = nn.Conv1d(c_in, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Buffer(nn.Module):
    def __init__(self, name: str, value: torch.Tensor):
        super().__init__()
        self.register_buffer(name, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.rnn = nn.LSTM(64, 64, num_layers=2)
        self.decoder = nn.Sequential(nn.ReLU(), nn.Conv1d(64, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        n = torch.arange(256, dtype=torch.float64)
        k = torch.arange(129, dtype=torch.float64)[:, None]
        window = 0.5 - 0.5 * torch.cos(2 * torch.pi * n / 256)
        phase = 2 * torch.pi * k * n / 256
        basis = torch.cat([torch.cos(phase), -torch.sin(phase)]) * window
        self.feature_extractor = _Buffer("forward_basis_buffer", basis.float()[:, None, :])
        self.adaptive_normalization = _Buffer(
            "filter_", torch.softmax(torch.randn(7, generator=g), 0)[None, None])
        self.first_layer = nn.Sequential(_Block(258, 16, True))
        layers = []
        for c_in, c_out in ((16, 32), (32, 32), (32, 64)):
            layers += [nn.Conv1d(c_in, c_out, 1), nn.BatchNorm1d(c_out), nn.ReLU(),
                       nn.Sequential(_Block(c_out, c_out, c_out == 64))]
        layers += [nn.Conv1d(64, 64, 1), nn.BatchNorm1d(64)]
        self.encoder = nn.Sequential(*layers)
        self.decoder = _Decoder()
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.BatchNorm1d):
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.normal_(0.0, 0.1, generator=g)
                    m.running_mean.normal_(0.0, 0.2, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
                elif isinstance(m, (nn.Conv1d, nn.LSTM)):
                    for p in m.parameters():
                        p.normal_(0.0, 0.3, generator=g)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Top(nn.Module):
    def __init__(self):
        super().__init__()
        self._model = _Net()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    path = tmp_path_factory.mktemp("vad") / "silero_vad.jit"
    torch.jit.save(torch.jit.script(_Top()), str(path))
    return str(path)


def _audio(seconds=3.0, seed=0):
    """Speech-like bursts (a 220 Hz harmonic tone) between silences."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * 220 * h * t) / h for h in range(1, 6))
    gate = ((t % 1.0) > 0.45).astype(np.float64)
    return (0.3 * tone * gate + 0.003 * rng.standard_normal(len(t))).astype(np.float32)


def _threshold(probs: np.ndarray, margin: float = 2e-4) -> float:
    """The midpoint between two neighbouring probabilities nearest their
    median such that neither it nor the hysteresis' low mark (it - 0.15)
    lies within `margin` of a probability: then probabilities that differ
    by less than the margin take the same branches."""
    mids = 0.5 * (np.sort(probs)[1:] + np.sort(probs)[:-1])
    for thr in mids[np.argsort(np.abs(mids - np.median(probs)))]:
        if all(np.abs(probs - t).min() > margin for t in (thr, max(thr - 0.15, 0.01))):
            return float(thr)
    raise AssertionError("no threshold clear of the probabilities")


def test_silero_probs_match_jax(blob):
    """The port's loader and the JAX package's on the same blob: speech
    probabilities within 5e-5 (the STFT, the log-compressed features up to
    ~14 through 5 conv blocks, and 94 LSTM steps in float32; measured
    1.5e-5); the JAX tree carried into the port (from_jax_silero_vad, the
    LSTM biases summed) gives the same within 1e-5."""
    audio = _audio()
    model = silero_vad.load_silero_vad(blob, device="cpu")
    params = jsilero.load_silero_vad(blob)
    got = silero_vad.silero_speech_probs(model, audio)
    ref = jsilero.silero_speech_probs(params, audio)
    assert got.shape == ref.shape == (94,)
    assert got.std() > 1e-3  # the random network does not answer the same everywhere
    np.testing.assert_allclose(got, ref, atol=5e-5)
    carried = silero_vad.build_silero_vad(convert.from_jax_silero_vad(params), "cpu")
    np.testing.assert_allclose(silero_vad.silero_speech_probs(carried, audio), got, atol=1e-5)


def test_speech_timestamps_with_silero_match_jax(blob):
    """get_speech_timestamps through silero on both sides: the same segments
    at a threshold that no probability lies within 2e-4 of (4x the
    probabilities' tolerance above)."""
    audio = _audio(seed=1)
    model = silero_vad.load_silero_vad(blob, device="cpu")
    params = jsilero.load_silero_vad(blob)
    threshold = _threshold(silero_vad.silero_speech_probs(model, audio))
    got = post.get_speech_timestamps(audio, threshold=threshold, vad_model=model)
    ref = jpost.get_speech_timestamps(audio, threshold=threshold, vad_params=params)
    assert got == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energy_vad_and_mask_bitwise(seed):
    """Without a silero model both packages take the energy VAD: the same
    segments and the same masked 32 kHz waveform, bit for bit."""
    ref16 = _audio(seconds=4.0, seed=seed)
    svc32 = np.random.default_rng(seed + 10).standard_normal(2 * len(ref16) + 37).astype(
        np.float32)
    assert post.get_speech_timestamps(ref16) == jpost.get_speech_timestamps(ref16)
    assert len(post.get_speech_timestamps(ref16)) >= 2
    np.testing.assert_array_equal(post.apply_vad_mask(svc32, ref16),
                                  jpost.apply_vad_mask(svc32, ref16))
    short = svc32[: len(ref16)]
    np.testing.assert_array_equal(post.apply_vad_mask(short, ref16),
                                  jpost.apply_vad_mask(short, ref16))


def test_apply_vad_mask_with_silero_matches_jax(blob):
    audio = _audio(seed=2)
    model = silero_vad.load_silero_vad(blob, device="cpu")
    params = jsilero.load_silero_vad(blob)
    threshold = _threshold(silero_vad.silero_speech_probs(model, audio))
    svc32 = np.random.default_rng(3).standard_normal(2 * len(audio)).astype(np.float32)
    np.testing.assert_array_equal(
        post.apply_vad_mask(svc32, audio, threshold=threshold, vad_model=model),
        jpost.apply_vad_mask(svc32, audio, threshold=threshold, vad_params=params))
