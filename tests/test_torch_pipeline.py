"""The whole slice: the port's svc_infer against the JAX package's, with the
same params and features, plus the chunk plan, pitch CSV and config."""

import os

import numpy as np
import pytest

import jax

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer.retrieval import DummyRetrieval as JDummyRetrieval
from whisper_vits_svc_tpu.utils.config import load_config as j_load_config
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def micro():
    """micro_hp's JAX infer graph with perturbed params (zero-init leaves
    such as snake alpha/beta become non-trivial) and the port with the same
    weights."""
    import jax.numpy as jnp

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


def _features(hp, t, seed=3):
    rng = np.random.default_rng(seed)
    pit = rng.uniform(100, 400, t).astype(np.float32)
    pit[20:31] = 0.0  # an unvoiced run
    return (rng.standard_normal(hp.vits.spk_dim).astype(np.float32),
            pit,
            (rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
            (rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32))


def test_svc_infer_matches_jax(micro):
    """Multi-chunk plan (t=90, out_chunk=30, hop_frame=4: the last chunk is
    right-padded), noise_scale=0. Encoder, reverse flow and generator in
    f32 on both sides, summed in other orders: 1e-4 on a tanh waveform."""
    hp, jmodel, params, port_hp, model = micro
    spk, pit, ppg, vec = _features(hp, 90)
    kw = dict(noise_scale=0.0, out_chunk=30, hop_frame=4, return_source=True)
    ref, ref_src = jpipeline.svc_infer(jmodel, params, JDummyRetrieval(), spk, pit, ppg,
                                       vec, hp, **kw)
    out, src = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                                  device="cpu", **kw)
    assert out.shape == ref.shape == (90 * hp.data.hop_length,)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(src, ref_src, atol=2e-5)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_chunk_batch_and_noise_seed(micro):
    """The prior noise is drawn per chunk in plan order from the seed, so a
    chunk batch gives the sequential walk's waveform (batched CPU convs may
    sum in another order, a few ulp of values near 1: 1e-5), and the seed is
    what changes it."""
    _, _, _, port_hp, model = micro
    spk, pit, ppg, vec = _features(port_hp, 70, seed=4)
    kw = dict(out_chunk=20, hop_frame=4, device="cpu")
    one = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp, **kw)
    three = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                               chunk_batch=3, **kw)
    other = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                               seed=1, **kw)
    np.testing.assert_allclose(three, one, atol=1e-5)
    assert np.abs(other - one).max() > 1e-3


@pytest.mark.parametrize("len_min,out_chunk,hop_frame",
                         [(90, 30, 4), (3005, 1000, 10), (1000, 1000, 10), (7, 1000, 10)])
def test_chunk_plan_matches_jax(len_min, out_chunk, hop_frame):
    assert (pipeline._chunk_plan(len_min, out_chunk, hop_frame)
            == jpipeline._chunk_plan(len_min, out_chunk, hop_frame))


def test_csv_pitch_round_trip(tmp_path):
    pit = np.array([0, 110.4, 220.9, 0, 440.0] * 30, np.float32)
    path = str(tmp_path / "p.csv")
    pipeline.save_csv_pitch(pit, path)
    np.testing.assert_array_equal(pipeline.load_csv_pitch(path), pit.astype(int))
    np.testing.assert_array_equal(pipeline.load_csv_pitch(path), jpipeline.load_csv_pitch(path))
    np.testing.assert_allclose(pipeline.shift_pitch(pit, 12), pit * 2)


def test_base_model_config_matches_yaml():
    hp = j_load_config(os.path.join(REPO, "configs", "base.yaml"))
    assert sorted(BASE_MODEL_CONFIG) == ["data", "gen", "log", "mpd", "mrd", "train", "vits"]
    for section in BASE_MODEL_CONFIG:
        assert BASE_MODEL_CONFIG[section] == hp[section].to_dict(), section


def test_source2wav_matches_jax():
    """The excitation's int16 debug waveform: scaled by 32768, clipped to
    [-32768, 32767], truncated, equal to the JAX package's."""
    src = np.random.default_rng(6).uniform(-1.2, 1.2, (1, 500, 1)).astype(np.float32)
    src[0, :3, 0] = (1.0, -1.0, 0.99999)
    got = pipeline.source2wav(src)
    assert got.dtype == np.int16 and got.shape == (500,)
    np.testing.assert_array_equal(got, jpipeline.source2wav(src))
    assert got.max() == 32767 and got.min() == -32768
