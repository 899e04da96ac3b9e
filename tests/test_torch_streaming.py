"""The port's StreamingSvc against the JAX package's, block by block, with
the same weights and features at noise_scale=0 (the prior noise streams of
the two cannot match); the window equivalence inside the port; a short last
block; the card's noise drawn on the host."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer.stream import StreamingSvc as JStreamingSvc
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params
from whisper_vits_svc_tpu_torch.nn.nsf import source_hn_nsf
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

BLOCK, CONTEXT = 20, 10


@pytest.fixture(scope="module")
def micro():
    """micro_hp's JAX infer graph with perturbed params and the port with
    the same weights."""
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
    model = pipeline.build_infer_model(port_hp, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return hp, jmodel, params, port_hp, model


def _features(hp, t, seed=5):
    rng = np.random.default_rng(seed)
    pit = rng.uniform(100, 400, t).astype(np.float32)
    pit[25:33] = 0.0  # an unvoiced run across a block seam
    return (rng.standard_normal(hp.vits.spk_dim).astype(np.float32) * 0.5,
            pit,
            (rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
            (rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32))


def _stream(stream, pit, ppg, vec, sizes):
    out, s = [], 0
    for n in sizes:
        out.append(stream.push(ppg[s : s + n], vec[s : s + n], pit[s : s + n]))
        s += n
    return out


def test_streaming_svc_matches_jax_block_by_block(micro):
    """Three whole blocks and a short last one (7 frames), noise_scale=0:
    the encoder, the reverse flow and the generator in float32 on both
    sides, summed in other orders, and the carried NSF phase: 1e-4 on a
    tanh waveform (the port's svc_infer bound against JAX). The carried
    phase after every block within 1e-5."""
    hp, jmodel, params, port_hp, model = micro
    spk, pit, ppg, vec = _features(hp, 67)
    sizes = [BLOCK, BLOCK, BLOCK, 7]
    ref_stream = JStreamingSvc(jmodel, params, spk, hp, block_frames=BLOCK,
                               context_frames=CONTEXT, noise_scale=0.0)
    got_stream = StreamingSvc(model, spk, port_hp, block_frames=BLOCK,
                              context_frames=CONTEXT, noise_scale=0.0, device="cpu")
    s = 0
    for k, n in enumerate(sizes):
        sl = slice(s, s + n)
        ref = ref_stream.push(ppg[sl], vec[sl], pit[sl])
        got = got_stream.push(ppg[sl], vec[sl], pit[sl])
        s += n
        assert got.shape == ref.shape == (n * hp.data.hop_length,), k
        assert np.abs(ref).max() > 1e-3
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"block {k}")
        np.testing.assert_allclose(got_stream.phase.numpy(), np.asarray(ref_stream.phase),
                                   atol=1e-5, err_msg=f"phase after block {k}")
        np.testing.assert_array_equal(got_stream.ctx_pit, ref_stream.ctx_pit)
    assert got_stream.ctx_valid == ref_stream.ctx_valid == CONTEXT


def test_streaming_block_equals_window_forward(micro):
    """Inside the port: block k is one SynthesizerInfer forward on the
    [context | block] window with the whole utterance's excitation sliced
    at the window (the JAX package's tight check). The excitations differ
    only by the carried phase's float32 rounding against the whole
    utterance's cumulative sum: 5e-5 on the waveform."""
    _, _, _, port_hp, model = micro
    hop = port_hp.data.hop_length
    spk, pit, ppg, vec = _features(port_hp, 4 * BLOCK, seed=6)
    stream = StreamingSvc(model, spk, port_hp, block_frames=BLOCK, context_frames=CONTEXT,
                          noise_scale=0.0, device="cpu")
    streamed = np.concatenate(_stream(stream, pit, ppg, vec, [BLOCK] * 4))
    whole_src = source_hn_nsf(torch.from_numpy(pit)[None], hop, port_hp.data.sampling_rate)
    for k in (1, 2, 3):
        s, e = k * BLOCK - CONTEXT, (k + 1) * BLOCK
        with torch.inference_mode():
            out = model(torch.from_numpy(ppg[s:e])[None], torch.from_numpy(vec[s:e])[None],
                        torch.from_numpy(pit[s:e])[None], torch.from_numpy(spk)[None],
                        torch.tensor([e - s]), whole_src[:, s * hop : e * hop], 0.0)
        ref = out[0, CONTEXT * hop :, 0].numpy()
        np.testing.assert_allclose(streamed[k * BLOCK * hop : (k + 1) * BLOCK * hop], ref,
                                   atol=5e-5, err_msg=f"block {k}")


def test_streaming_short_block_and_noise_seed(micro):
    """A short block returns its own frames only; with noise on, the noise
    comes from the stream's seed (the same seed, the same audio; another
    seed, other audio), one draw per block."""
    _, _, _, port_hp, model = micro
    hop = port_hp.data.hop_length
    spk, pit, ppg, vec = _features(port_hp, 2 * BLOCK, seed=7)
    runs = []
    for seed in (0, 0, 1):
        stream = StreamingSvc(model, spk, port_hp, block_frames=BLOCK, context_frames=CONTEXT,
                              noise_scale=0.7, seed=seed, device="cpu")
        runs.append(np.concatenate(_stream(stream, pit, ppg, vec, [BLOCK, 3])))
    assert runs[0].shape == ((BLOCK + 3) * hop,)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.abs(runs[2] - runs[0]).max() > 1e-3
    with pytest.raises(AssertionError, match="at most"):
        stream.push(ppg[: BLOCK + 1], vec[: BLOCK + 1], pit[: BLOCK + 1])
