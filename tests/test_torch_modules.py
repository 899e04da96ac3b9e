"""Each ported module against its JAX counterpart at tiny widths.

Inputs and parameter perturbations come from numpy seeds; JAX params go to
the port through models/convert.py's per-module mappings (the pieces of
`from_jax_params`). Every comparison is float32 on the CPU; each test names
its tolerance and why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models.generator import Generator as JGenerator
from whisper_vits_svc_tpu.models.synthesizer import TextEncoder as JTextEncoder
from whisper_vits_svc_tpu.nn.amp import AMPBlock as JAMPBlock
from whisper_vits_svc_tpu.nn.attention import RelPosTransformer as JRelPos
from whisper_vits_svc_tpu.nn.conv import Conv1d as JConv1d
from whisper_vits_svc_tpu.nn.conv import ConvTranspose1d as JConvT
from whisper_vits_svc_tpu.nn.flow import ResidualCouplingBlock as JFlow
from whisper_vits_svc_tpu.nn.flow import flip as j_flip
from whisper_vits_svc_tpu.nn.nsf import source_hn_nsf as j_source_hn_nsf
from whisper_vits_svc_tpu.utils.pitch import f0_to_coarse as j_f0_to_coarse
from whisper_vits_svc_tpu.utils.testing import tiny_hp
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models.generator import Generator
from whisper_vits_svc_tpu_torch.models.synthesizer import TextEncoder
from whisper_vits_svc_tpu_torch.nn.amp import AMPBlock
from whisper_vits_svc_tpu_torch.nn.attention import RelPosTransformer
from whisper_vits_svc_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from whisper_vits_svc_tpu_torch.nn.flow import Flip, ResidualCouplingBlock, flip
from whisper_vits_svc_tpu_torch.nn.nsf import source_hn_nsf
from whisper_vits_svc_tpu_torch.utils.pitch import f0_to_coarse


def _init(module, *args, seed=0, **kw):
    """JAX params with every leaf perturbed (zero-initialized leaves such as
    snake alpha/beta or the coupling post conv become non-trivial)."""
    rng = np.random.default_rng(seed)
    params = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed + 1)},
        *args, **kw))()["params"]
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _apply(module, params, *args, **kw):
    """Jitted JAX forward (eager flax dispatch is slow on the CPU)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(params, *args)


def _load(module, fill, params):
    sd = {}
    fill(sd, "m", params)
    module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return module


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k,stride,padding,dilation,wn", [
    (5, 1, 2, 1, False),    # TextEncoder pre/hub
    (3, 1, 5, 5, True),     # AMP convs1 at dilation 5
    (10, 5, 2, 1, False),   # strided noise conv
    (1, 1, 0, 1, True),     # WN res/skip 1x1 (matmul path)
])
def test_conv1d(k, stride, padding, dilation, wn):
    """f32 conv, same products in another summation order: 1e-5."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    jm = JConv1d(8, k, stride=stride, padding=padding, dilation=dilation, weight_norm=wn)
    p = _init(jm, x)
    ref = np.asarray(_apply(jm, p, x))
    port = _load(Conv1d(6, 8, k, stride, padding, dilation, weight_norm=wn),
                 convert._wn_conv1d if wn else convert._conv1d, p)
    out = port.forward_ntc(_t(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,stride", [(15, 5), (8, 4), (4, 2)])
def test_conv_transpose1d_weight_norm(k, stride):
    """Output length T*stride; the JAX polyphase form sums the same taps in
    another order: 1e-5."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 13, 12)).astype(np.float32)
    jm = JConvT(6, k, stride=stride, padding=(k - stride) // 2, weight_norm=True)
    p = _init(jm, x)
    ref = np.asarray(_apply(jm, p, x))
    port = _load(ConvTranspose1d(12, 6, k, stride, (k - stride) // 2), convert._wn_convT1d, p)
    out = port(_t(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    assert out.shape == ref.shape == (2, 13 * stride, 6)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("length", [3, 4, 12])
def test_rel_pos_transformer(length):
    """Masked rel-pos attention, including L <= window (the sliced table);
    two layers of f32 matmuls, softmax and LayerNorm: 2e-5."""
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 16)).astype(np.float32)
    lengths = np.array([length, max(1, length - 2)])
    mask = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    jm = JRelPos(16, 24, 2, 2, kernel_size=3)
    p = _init(jm, x, mask)
    ref = np.asarray(_apply(jm, p, x, mask))
    port = _load(RelPosTransformer(16, 24, 2, 2, kernel_size=3), convert.rel_pos_transformer, p)
    out = port(_t(x), _t(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("reverse", [True, False])
def test_flow(reverse):
    """Two SNAC couplings over 3-layer WN stacks, f32: 2e-5 on x, 1e-4 on the
    logdet (a sum over T*C terms)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, 8)).astype(np.float32)
    mask = np.ones((2, 20, 1), np.float32)
    mask[1, 15:] = 0
    g = rng.standard_normal((2, 6)).astype(np.float32)
    jm = JFlow(8, 16, 5, 1, 3, n_flows=2, gin_channels=6)
    p = _init(jm, x, mask, g)
    ref_x, ref_ld = _apply(jm, p, x, mask, g, reverse=reverse)
    port = _load(ResidualCouplingBlock(8, 16, 5, 1, 3, n_flows=2, gin_channels=6),
                 convert.coupling_block, p)
    out_x, out_ld = port(_t(x), _t(mask), _t(g), reverse=reverse)
    np.testing.assert_allclose(out_x.detach().numpy(), np.asarray(ref_x), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(out_ld.detach().numpy(), np.asarray(ref_ld), atol=1e-4, rtol=1e-5)


def test_flip_matches_jax():
    """The channel flip between couplings, a permutation: equal to the bit."""
    x = np.random.default_rng(8).standard_normal((2, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(flip(_t(x)).numpy(), np.asarray(j_flip(jnp.asarray(x))))
    assert torch.equal(Flip()(_t(x)), flip(_t(x)))


def test_source_hn_nsf_deterministic_with_phase_carry():
    """rng=None excitation with unvoiced frames; sin of phases up to ~100
    cycles in f32, where sin implementations differ by a few ulp of the
    argument: 2e-5. The phase0 carry makes two blocks equal one utterance."""
    rng = np.random.default_rng(11)
    f0 = rng.uniform(80, 900, (2, 60)).astype(np.float32)
    f0[:, 10:17] = 0.0
    f0[1, 40:] = 0.0
    ref = np.asarray(j_source_hn_nsf(jnp.asarray(f0), 64, 16000, rng=None))
    out = source_hn_nsf(_t(f0), 64, 16000).numpy()
    assert out.shape == ref.shape == (2, 60 * 64, 1)
    np.testing.assert_allclose(out, ref, atol=2e-5)

    a, phase = source_hn_nsf(_t(f0[:, :25]), 64, 16000, return_phase=True)
    b = source_hn_nsf(_t(f0[:, 25:]), 64, 16000, phase0=phase)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), out, atol=2e-5)
    ref_b = np.asarray(j_source_hn_nsf(jnp.asarray(f0[:, 25:]), 64, 16000, rng=None,
                                       phase0=jnp.asarray(phase.numpy())))
    np.testing.assert_allclose(b.numpy(), ref_b, atol=2e-5)


def test_sine_harmonics_noise_mode():
    """With a torch.Generator: the fundamental keeps its phase (only the
    overtones get random initial phases), voiced samples carry noise of std
    0.003 and unvoiced ones noise of std 0.1/3. Statistics over 48k samples:
    10% on the stds."""
    from whisper_vits_svc_tpu_torch.nn.nsf import sine_harmonics

    f0 = torch.full((1, 300), 220.0)
    f0[:, 150:] = 0.0
    det = sine_harmonics(f0, 320, 32000)
    noisy = sine_harmonics(f0, 320, 32000, rng=torch.Generator().manual_seed(0))
    voiced = (noisy - det)[0, : 150 * 320, 0]
    unvoiced = noisy[0, 150 * 320 :]
    assert abs(voiced.std().item() / 0.003 - 1) < 0.1
    assert abs(unvoiced.std().item() / (0.1 / 3) - 1) < 0.1
    assert (noisy[0, :320, 1:] - det[0, :320, 1:]).abs().max() > 0.01


def test_amp_block():
    """k=11 at dilation 5, channel-major: four snakes and four convs in f32:
    2e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 200)).astype(np.float32)
    jm = JAMPBlock(6, 11, (5, 1), layout="NCT")
    p = _init(jm, x)
    ref = np.asarray(_apply(jm, p, x))
    port = _load(AMPBlock(6, 11, (5, 1)), convert.amp_block, p)
    out = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def test_generator_tiny():
    """tiny_hp's generator (3 stages, dilations (1, 3)) on a precomputed
    excitation; a deep f32 stack ending in tanh: 1e-4."""
    hp = tiny_hp()
    rng = np.random.default_rng(9)
    t, hop = 12, 32
    spk = rng.standard_normal((2, 16)).astype(np.float32)
    x = (rng.standard_normal((2, t, 32)) * 0.5).astype(np.float32)
    f0 = rng.uniform(100, 300, (2, t)).astype(np.float32)
    source = np.asarray(j_source_hn_nsf(jnp.asarray(f0), hop, 3200, rng=None))
    kw = dict(upsample_input=32, upsample_initial_channel=32,
              upsample_rates=tuple(hp.gen.upsample_rates),
              upsample_kernel_sizes=tuple(hp.gen.upsample_kernel_sizes),
              resblock_kernel_sizes=tuple(hp.gen.resblock_kernel_sizes),
              resblock_dilation_sizes=tuple(tuple(d) for d in hp.gen.resblock_dilation_sizes),
              spk_dim=16)
    jm = JGenerator(**kw, sampling_rate=3200)
    p = _init(jm, spk, x, har_source=source)
    ref = np.asarray(_apply(jm, p, spk, x, har_source=source))
    port = _load(Generator(**kw), convert.generator, p)
    out = port(_t(spk), _t(x), _t(source)).detach().numpy()
    assert out.shape == ref.shape == (2, t * hop, 1)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_text_encoder_mean_path():
    """noise_scale=0: z is the masked prior mean; 2 transformer layers plus
    k=5 input convs in f32: 5e-5."""
    rng = np.random.default_rng(13)
    b, t = 2, 15
    ppg = rng.standard_normal((b, t, 20)).astype(np.float32)
    vec = rng.standard_normal((b, t, 12)).astype(np.float32)
    f0 = rng.uniform(60, 700, (b, t)).astype(np.float32)
    lengths = np.array([t, 9], np.int32)
    coarse = np.asarray(j_f0_to_coarse(jnp.asarray(f0)))
    jm = JTextEncoder(20, 12, 8, 16, 24, 2, 2, 3, 0.1)
    p = _init(jm, ppg, lengths, vec, coarse)
    ref = _apply(jm, p, ppg, lengths, vec, coarse, noise_scale=0.0,
                   rngs={"noise": jax.random.PRNGKey(3)})
    port = _load(TextEncoder(20, 12, 8, 16, 24, 2, 2, 3), convert.text_encoder, p)
    out = port(_t(ppg), _t(lengths), _t(vec), f0_to_coarse(_t(f0)), noise_scale=0.0)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=5e-5, rtol=1e-5)

    # prior sample: z = (m + noise * exp(logs) * scale) * mask, noise passed in
    # or drawn from an explicit generator
    _, m, logs, mask, _ = ref
    noise = rng.standard_normal(np.shape(m)).astype(np.float32)
    z, *_ = port(_t(ppg), _t(lengths), _t(vec), f0_to_coarse(_t(f0)), noise_scale=0.7,
                 noise=_t(noise))
    want = (np.asarray(m) + noise * np.exp(np.asarray(logs)) * 0.7) * np.asarray(mask)
    np.testing.assert_allclose(z.detach().numpy(), want, atol=5e-5, rtol=1e-4)
    draws = [port(_t(ppg), _t(lengths), _t(vec), f0_to_coarse(_t(f0)), noise_scale=0.7,
                  generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_f0_to_coarse():
    """Integer bins: exact, including 0 Hz and the clamp above 1100 Hz."""
    f0 = np.concatenate([[0.0, 49.0, 50.0, 1100.0, 3000.0],
                         np.random.default_rng(0).uniform(30, 1200, 500)]).astype(np.float32)
    np.testing.assert_array_equal(f0_to_coarse(_t(f0)).numpy(),
                                  np.asarray(j_f0_to_coarse(jnp.asarray(f0))))
