"""The training slice's modules in the port against the JAX package, each on
the same weights and inputs at small sizes: Conv2d and grouped Conv1d with
weight norm, the gin-conditioned WN, the gradient reversal and speaker
classifier, the posterior encoder, every discriminator's feature maps and
scores, the STFT and mel conventions and every loss. Forward values at atol
2e-5 / rtol 1e-5 (f32 on both sides, summed in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models import synthesizer as jsyn
from whisper_vits_svc_tpu.models.discriminator import Discriminator as JDiscriminator
from whisper_vits_svc_tpu.nn import conv as jconv
from whisper_vits_svc_tpu.nn import grl as jgrl
from whisper_vits_svc_tpu.nn.wn import WN as JWN
from whisper_vits_svc_tpu.nn.wn import gated_activation as j_gated_activation
from whisper_vits_svc_tpu.ops import mel as jmel
from whisper_vits_svc_tpu.ops import stft as jstft
from whisper_vits_svc_tpu.train import losses as jlosses
from whisper_vits_svc_tpu_torch.models import convert as tconvert
from whisper_vits_svc_tpu_torch.models.discriminator import Discriminator
from whisper_vits_svc_tpu_torch.models.synthesizer import PosteriorEncoder, slice_segments
from whisper_vits_svc_tpu_torch.nn import attention as tattention
from whisper_vits_svc_tpu_torch.nn.conv import Conv1d, Conv2d
from whisper_vits_svc_tpu_torch.nn.grl import GradientReversal, SpeakerClassifier, gradient_reversal
from whisper_vits_svc_tpu_torch.nn.wn import WN, gated_activation
from whisper_vits_svc_tpu_torch.ops import mel as tmel
from whisper_vits_svc_tpu_torch.ops import stft as tstft
from whisper_vits_svc_tpu_torch.train import losses as tlosses

TOL = dict(atol=2e-5, rtol=1e-5)


def _init(module, *args, seed=0, **kw):
    """JAX params with every leaf perturbed, so that no two weight-norm g/v
    pairs are trivially equal."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args, **kw)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _sd(fn, p):
    sd = {}
    fn(sd, "m", p)
    return {k[2:]: v for k, v in sd.items()}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kernel,stride,padding", [((5, 1), (3, 1), (2, 0)),
                                                   ((3, 9), (1, 2), (1, 4))])
def test_conv2d_weight_norm_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 3, 11, 20)  # NCHW
    jm = jconv.Conv2d(8, kernel, stride, padding, weight_norm=True)
    params = _init(jm, jnp.asarray(x.transpose(0, 2, 3, 1)))
    ref = np.asarray(jm.apply({"params": params}, x.transpose(0, 2, 3, 1)))
    m = Conv2d(3, 8, kernel, stride, padding)
    m.load_state_dict(_sd(tconvert._wn_conv2d, params), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("merge_groups_to", [None, 1])
def test_grouped_conv1d_matches_jax(merge_groups_to):
    """The MSD's grouped k=41 stride-4 conv; the JAX merged-group execution
    (merge_groups_to) has the same values as plain groups."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 16, 300)  # NCT
    jm = jconv.Conv1d(64, 41, stride=4, padding=20, groups=4, weight_norm=True,
                      merge_groups_to=merge_groups_to)
    params = _init(jm, jnp.asarray(x.transpose(0, 2, 1)))
    ref = np.asarray(jm.apply({"params": params}, x.transpose(0, 2, 1)))
    m = Conv1d(16, 64, 41, stride=4, padding=20, groups=4, weight_norm=True)
    m.load_state_dict(_sd(tconvert._wn_conv1d, params), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 2, 1), **TOL)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_wn_with_gin_matches_jax(n_layers):
    """Both JAX forms: the layer loop (n < 3) and the scanned stack."""
    rng = np.random.default_rng(2)
    x, g = _rand(rng, 2, 17, 8), _rand(rng, 2, 1, 6)
    mask = np.ones((2, 17, 1), np.float32)
    mask[1, 12:] = 0.0
    jm = JWN(8, 5, 1, n_layers, gin_channels=6)
    params = _init(jm, x, mask, g=g)
    ref = np.asarray(jm.apply({"params": params}, x, mask, g=g))
    m = WN(8, 5, 1, n_layers, gin_channels=6)
    m.load_state_dict(_sd(tconvert._wn, params), strict=True)
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (x, mask, g))).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_gradient_reversal_matches_jax_and_gradchecks():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 3, 5), _rand(rng, 3, 5)
    ref = jax.grad(lambda a: jnp.sum(w * jgrl.gradient_reversal(a, 0.7)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = GradientReversal.apply(xt, 0.7)
    torch.testing.assert_close(y, torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0, atol=0)
    # gradcheck compares with finite differences of the forward, which is the
    # identity; two reversals with lambdas multiplying to 1 are the identity
    # both ways, so the composition holds the backward's -lambda scaling
    x64 = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    for l1, l2 in ((2.0, 0.5), (1.0, 1.0), (0.25, 4.0)):
        assert torch.autograd.gradcheck(
            lambda a: GradientReversal.apply(GradientReversal.apply(a, l1), l2), (x64,))


def test_gradient_reversal_function_matches_jax():
    """The function form: the identity forward, -lambda times the cotangent
    backward, to the bit as jax.grad of the JAX function."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 2, 7), _rand(rng, 2, 7)
    for lam in (1.0, 0.3):
        ref = jax.grad(lambda a: jnp.sum(w * jgrl.gradient_reversal(a, lam)))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = gradient_reversal(xt, lam)
        assert torch.equal(y, torch.from_numpy(x))
        (y * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))


def test_gated_activation_matches_jax():
    """tanh * sigmoid of the two channel halves of x_in + g_l, on [B, T, 2h]
    (the JAX layout) and on [B, 2h, T] with dim=1 (the port's WN), g_l None
    adding nothing: f32 transcendental rounding, 1e-6."""
    rng = np.random.default_rng(5)
    x, g = _rand(rng, 2, 9, 8), _rand(rng, 2, 1, 8)
    ref = np.asarray(j_gated_activation(jnp.asarray(x), jnp.asarray(g), 4))
    got = gated_activation(torch.from_numpy(x), torch.from_numpy(g), 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    cm = gated_activation(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(g).transpose(1, 2),
                          4, dim=1)
    np.testing.assert_array_equal(cm.transpose(1, 2).numpy(), got)
    ref0 = np.asarray(j_gated_activation(jnp.asarray(x), 0.0, 4))
    np.testing.assert_allclose(gated_activation(torch.from_numpy(x), None, 4).numpy(), ref0,
                               rtol=0, atol=1e-6)


def test_speaker_classifier_matches_jax():
    """Values, and the reversed input gradient against jax.grad."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 2, 13, 8), _rand(rng, 2, 5)
    jm = jgrl.SpeakerClassifier(8, 5)
    params = _init(jm, x)
    ref = np.asarray(jm.apply({"params": params}, x))
    ref_dx = jax.grad(lambda a: jnp.sum(w * jm.apply({"params": params}, a)))(jnp.asarray(x))
    sd = {}
    for j in range(3):
        tconvert._wn_conv1d(sd, f"classifier.{2 * j + 1}", params[f"conv_{j}"])
    m = SpeakerClassifier(8, 5)
    m.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **TOL)


def test_posterior_encoder_matches_jax():
    """(z, m, logs, mask) at noise_scale 0, with a shorter second item."""
    rng = np.random.default_rng(5)
    spec, g = np.abs(_rand(rng, 2, 15, 9)), _rand(rng, 2, 6)
    lengths = np.array([15, 11], np.int32)
    jm = jsyn.PosteriorEncoder(4, 8, 5, 1, 3, gin_channels=6)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "noise": jax.random.PRNGKey(1)}, spec, lengths, g)["params"]
    ref = jm.apply({"params": params}, spec, lengths, g, noise_scale=0.0,
                   rngs={"noise": jax.random.PRNGKey(2)})
    sd = {}
    tconvert._conv1d(sd, "pre", params["pre"])
    tconvert._wn(sd, "enc", params["enc"])
    tconvert._conv1d(sd, "proj", params["proj"])
    m = PosteriorEncoder(9, 4, 8, 5, 1, 3, gin_channels=6)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (spec, lengths, g)), noise_scale=0.0)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_slice_segments_matches_jax():
    rng = np.random.default_rng(6)
    x = _rand(rng, 3, 40, 2)
    ids = np.array([0, 7, 39], np.int32)  # the last start is clamped back
    ref = jsyn.slice_segments(jnp.asarray(x), jnp.asarray(ids), 10)
    got = slice_segments(torch.from_numpy(x), torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def discriminators():
    """The JAX Discriminator (plain fmap layout, folded MRD and merged MSD
    groups in execution) and the port's, same weights; 300 samples so the
    period-7 MPD reflect-pads."""
    kw = dict(mrd_resolutions=((64, 16, 32), (128, 32, 64)), mpd_periods=(2, 7))
    jm = JDiscriminator(**kw)
    x = _rand(np.random.default_rng(7), 2, 300, 1, scale=0.3)
    params = _init(jm, jnp.asarray(x))
    ref = jm.apply({"params": params}, x)
    m = Discriminator(**kw)
    m.load_state_dict(tconvert.from_jax_disc_params(params), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    return ref, got


@pytest.mark.parametrize("index,kind", [(0, "mrd"), (1, "mrd"), (2, "mpd"), (3, "mpd"),
                                        (4, "msd")])
def test_discriminator_fmaps_and_scores_match_jax(discriminators, index, kind):
    ref, got = discriminators
    (ref_fmaps, ref_score), (fmaps, score) = ref[index], got[index]
    assert len(fmaps) == len(ref_fmaps) == (7 if kind == "msd" else 6)
    for f, r in zip(fmaps, ref_fmaps):
        r = np.asarray(r)
        r = r.transpose(0, 2, 1) if r.ndim == 3 else r.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f.numpy(), r, **TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), **TOL)


STFT_CASES = {
    "mel": (lambda y, m: m.mel_spectrogram(y, 128, 8, 3200, 32, 128, 50.0, 1600.0)),
    "stft_loss": (lambda y, m: m.stft_loss_magnitude(y, 64, 16, 32)),
    "mrd": (lambda y, m: m.mrd_magnitude(y, 128, 32, 64)),
    "magnitude_eps": (lambda y, m: m.stft_magnitude(y, 64, 16, 48, mag_eps=1e-6)),
}


@pytest.mark.parametrize("case", sorted(STFT_CASES))
def test_stft_conventions_match_jax(case):
    y = _rand(np.random.default_rng(8), 2, 500, scale=0.3)
    fn = STFT_CASES[case]
    ref = np.asarray(fn(jnp.asarray(y), jstft))
    got = fn(torch.from_numpy(y), tstft).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_mel_filterbank_matches_jax():
    for args in ((32000, 1024, 100, 50.0, 16000.0), (48000, 2048, 128, 0.0, None, True, None)):
        np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))


def _loss_inputs(rng):
    def disc(n):
        return [([_rand(rng, 2, 3, 4), _rand(rng, 2, 5)], _rand(rng, 2, 6)) for _ in range(n)]

    return dict(
        kl=(_rand(rng, 2, 9, 4), _rand(rng, 2, 9, 4, scale=0.2), _rand(rng, 2, 9, 4),
            _rand(rng, 2, 9, 4, scale=0.2), _rand(rng, 2), (rng.random((2, 9, 1)) > 0.2)
            .astype(np.float32)),
        adv=(disc(3),),
        fm=(disc(3), disc(3)),
        disc=(disc(3), disc(3)),
        mrstft=(_rand(rng, 2, 400, scale=0.3), _rand(rng, 2, 400, scale=0.3),
                [(64, 16, 32), (128, 32, 64)]),
        mel=(_rand(rng, 2, 400, scale=0.3), _rand(rng, 2, 400, scale=0.3),
             dict(filter_length=128, mel_channels=8, sampling_rate=3200, hop_length=32,
                  win_length=128, mel_fmin=50.0, mel_fmax=1600.0)),
        spk=(_rand(rng, 3, 6), _rand(rng, 3, 6)),
    )


LOSSES = dict(kl="kl_loss", adv="generator_adversarial_loss", fm="feature_matching_loss",
              disc="discriminator_adversarial_loss", mrstft="multi_resolution_stft_loss",
              mel="mel_l1_loss", spk="cosine_speaker_loss")


def _as(tree, to):
    if isinstance(tree, np.ndarray):
        return to(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as(t, to) for t in tree)
    return tree


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """The JAX fmaps are NHWC and the port's NCHW; the losses are means, so
    the inputs are given in one layout to both."""
    args = _loss_inputs(np.random.default_rng(9))[name]
    ref = getattr(jlosses, LOSSES[name])(*_as(args, jnp.asarray))
    got = getattr(tlosses, LOSSES[name])(*_as(args, torch.from_numpy))
    for g, r in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                    np.atleast_1d(ref) if not isinstance(ref, tuple) else ref):
        np.testing.assert_allclose(float(g), float(r), atol=2e-5, rtol=1e-5)


def test_feature_matching_detaches_real_fmaps():
    f = torch.randn(2, 3, requires_grad=True)
    r = torch.randn(2, 3, requires_grad=True)
    tlosses.feature_matching_loss([([f], torch.zeros(2))], [([r], torch.zeros(2))]).backward()
    assert f.grad is not None and r.grad is None


def test_dropout_is_flax_inverted_dropout():
    gen = torch.Generator().manual_seed(0)
    y = tattention.dropout(torch.ones(200_000), 0.1, gen)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    again = tattention.dropout(torch.ones(200_000), 0.1, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, y, rtol=0, atol=0)


def test_transformer_dropout_only_in_training():
    torch.manual_seed(0)
    enc = tattention.RelPosTransformer(8, 16, 2, 2, 3, p_dropout=0.1)
    enc.init_weights(torch.Generator().manual_seed(0))
    x, mask = torch.randn(2, 12, 8), torch.ones(2, 12, 1)
    with torch.no_grad():
        base = enc(x, mask)
        torch.testing.assert_close(enc(x, mask, train=False), base, rtol=0, atol=0)
        a = enc(x, mask, train=True, generator=torch.Generator().manual_seed(1))
        b = enc(x, mask, train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - base).abs().max() > 1e-3

