"""bfloat16 synthesis, fast_edges and pitch2source: the port's svc_infer
against the JAX package's on the same params and features (micro_hp, the
CPU, noise_scale=0), and the whisper encoder's compute_dtype.

On the CPU, XLA and torch round bfloat16 differently: the JAX package's
channel-major AMP convolutions round every tap's product and sum to
bfloat16, oneDNN's (and cuDNN's, on the card) accumulate in float32 and
round once. The port's bfloat16 waveform is held (1) within the JAX
package's own bound of its float32 waveform (tests/test_infer_pipeline.py:
168-183), (2) no farther from the float32 waveform than JAX's bfloat16 is,
and (3) against JAX's bfloat16 waveform, within 1.15 times the distance
between JAX's bfloat16 and float32 waveforms (measured 1.06-1.11 times:
the two bfloat16 roundings are partly independent)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer.retrieval import DummyRetrieval as JDummyRetrieval
from whisper_vits_svc_tpu.models import whisper as jwhisper
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

KW = dict(noise_scale=0.0, out_chunk=30, hop_frame=4)


@pytest.fixture(scope="module")
def micro():
    """micro_hp's JAX infer graph with perturbed params and the port with
    the same weights, both exact-edge and fast-edge."""
    hp = micro_hp()
    jmodel = jpipeline.build_infer_model(hp)
    t = 8
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, hp.vits.ppg_dim)), jnp.zeros((1, t, hp.vits.vec_dim)),
        jnp.full((1, t), 200.0), jnp.zeros((1, hp.vits.spk_dim)),
        jnp.full((1,), t, jnp.int32), jnp.zeros((1, t * hp.data.hop_length, 1)),
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    port_hp = config_from_dict(hp)
    models = {}
    for fast in (False, True):
        m = pipeline.build_infer_model(port_hp, device="cpu", fast_edges=fast)
        m.load_state_dict(convert.from_jax_params(params), strict=True)
        models[fast] = m
    return hp, jmodel, params, port_hp, models


def _features(hp, t, seed=3):
    rng = np.random.default_rng(seed)
    pit = rng.uniform(100, 400, t).astype(np.float32)
    pit[20:31] = 0.0  # an unvoiced run
    return (rng.standard_normal(hp.vits.spk_dim).astype(np.float32), pit,
            (rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
            (rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32))


def _rms(a, b):
    return float(np.sqrt(np.mean(np.square(a - b))))


def test_bf16_svc_infer_against_jax(micro):
    """90 frames in 3 chunks at noise_scale 0, measured: JAX bf16 vs f32
    rms 5.93e-3 (median 3.61e-3); the port's bf16 vs its f32 rms 5.49e-3
    (median 3.05e-3, correlation 0.99975); the port's bf16 vs JAX's bf16
    rms 6.46e-3."""
    hp, jmodel, params, port_hp, models = micro
    model = models[False]
    spk, pit, ppg, vec = _features(hp, 90)
    jf = jpipeline.svc_infer(jmodel, params, JDummyRetrieval(), spk, pit, ppg, vec, hp, **KW)
    jb = jpipeline.svc_infer(jmodel, params, JDummyRetrieval(), spk, pit, ppg, vec, hp,
                             compute_dtype=jnp.bfloat16, **KW)
    pf = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                            device="cpu", **KW)
    pb = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                            device="cpu", compute_dtype=torch.bfloat16, **KW)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert pb.dtype == np.float32 and pb.shape == pf.shape == jb.shape
    assert np.isfinite(pb).all() and np.abs(pb).max() > 1e-2
    np.testing.assert_allclose(pf, jf, atol=1e-4)
    # (1) the JAX package's own bound of bf16 against f32
    assert np.median(np.abs(pb - pf)) < 0.05
    assert np.corrcoef(pb, pf)[0, 1] > 0.9
    # (2) no farther from f32 than JAX's bf16 is
    assert _rms(pb, pf) <= _rms(jb, jf)
    assert np.median(np.abs(pb - pf)) <= np.median(np.abs(jb - jf))
    # (3) against JAX's bf16
    assert _rms(pb, jb) <= 1.15 * _rms(jb, jf)
    assert np.corrcoef(pb, jb)[0, 1] > 0.999


def test_bf16_chunk_batch_equals_sequential(micro):
    """The bfloat16 path batched three chunks a call gives the sequential
    walk's waveform (one bfloat16 ulp of the tanh output, 2^-8)."""
    hp, _, _, port_hp, models = micro
    spk, pit, ppg, vec = _features(hp, 70, seed=4)
    kw = dict(KW, device="cpu", compute_dtype=torch.bfloat16)
    one = pipeline.svc_infer(models[False], DummyRetrieval(), spk, pit, ppg, vec, port_hp, **kw)
    three = pipeline.svc_infer(models[False], DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                               chunk_batch=3, **kw)
    np.testing.assert_allclose(three, one, atol=2.0 ** -8)


def test_fast_edges_matches_jax_fast_edges(micro):
    """build_infer_model(fast_edges=True) on both sides: the zero-padded
    snake chain, float32, 1e-5 (measured 1.1e-6); it differs from the
    exact-edge waveform (at the utterance's ends)."""
    hp, _, params, port_hp, models = micro
    spk, pit, ppg, vec = _features(hp, 90)
    jfast = jpipeline.build_infer_model(hp, fast_edges=True)
    ref = jpipeline.svc_infer(jfast, params, JDummyRetrieval(), spk, pit, ppg, vec, hp, **KW)
    got = pipeline.svc_infer(models[True], DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                             device="cpu", **KW)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    exact = pipeline.svc_infer(models[False], DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                               device="cpu", **KW)
    assert np.abs(got - exact).max() > 1e-3
    assert all(not s.exact_edges for s in models[True].modules() if hasattr(s, "exact_edges"))


def test_pitch2source_matches_jax(micro):
    """SynthesizerInfer.pitch2source at rng=None (the deterministic
    excitation) against the JAX module's, 2e-5 (sines of float32 phases)."""
    hp, jmodel, _, _, models = micro
    f0 = np.random.default_rng(6).uniform(80, 500, (2, 40)).astype(np.float32)
    f0[:, 10:15] = 0.0
    got = models[False].pitch2source(torch.from_numpy(f0)).numpy()
    ref = np.asarray(jmodel.pitch2source(jnp.asarray(f0), rng=None))
    assert got.shape == ref.shape == (2, 40 * hp.data.hop_length, 1)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_whisper_compute_dtype_bf16_matches_jax():
    """compute_dtype=bfloat16: the stem convolutions in bfloat16 and the
    blocks in float32 on both sides; 2 layers of width 64 on 3 s. Measured:
    the port's bf16 vs JAX's 1.22e-2 (XLA adds the stem biases after
    rounding, oneDNN before), JAX's bf16 vs its f32 7.0e-3, the port's
    7.2e-3: 2.5e-2. The float32 default within 1e-4 (measured 9.5e-7)."""
    jm32 = jwhisper.WhisperEncoder(n_mels=80, n_ctx=1500, n_state=64, n_head=4, n_layer=2)
    params = jm32.init(jax.random.PRNGKey(0), jnp.zeros((1, 1500, 80)))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    jm16 = jwhisper.WhisperEncoder(n_mels=80, n_ctx=1500, n_state=64, n_head=4, n_layer=2,
                                   compute_dtype=jnp.bfloat16)
    mel = (rng.standard_normal((1, 300, 80)) * 0.5).astype(np.float32)
    sd = convert.from_jax_whisper(params)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        pm = pwhisper.WhisperEncoder(n_state=64, n_head=4, n_layer=2, compute_dtype=dt).eval()
        pm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[dt] = pm(torch.from_numpy(mel)).numpy()
    ref32 = np.asarray(jm32.apply({"params": params}, jnp.asarray(mel)))
    ref16 = np.asarray(jm16.apply({"params": params}, jnp.asarray(mel)))
    assert outs[torch.bfloat16].dtype == np.float32
    np.testing.assert_allclose(outs[torch.float32], ref32, atol=1e-4)
    np.testing.assert_allclose(outs[torch.bfloat16], ref16, atol=2.5e-2)
    assert np.abs(outs[torch.bfloat16] - outs[torch.float32]).max() > 1e-4
