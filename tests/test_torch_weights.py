"""Weight I/O of the port: JAX param trees, JAX `.ckpt` files and `.pth`
state_dicts."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from whisper_vits_svc_tpu.models import convert as jconvert
from whisper_vits_svc_tpu.models.synthesizer import SynthesizerInfer as JSynthesizerInfer
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params, load_jax_ckpt
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

# narrow widths at the default depths that the JAX converter hard-codes
# (6 encoder layers, 4 flows of 4 WN layers, 3 dilations per resblock)
NARROW = dict(
    data=dict(sampling_rate=3200, filter_length=128, hop_length=32),
    vits=dict(ppg_dim=12, vec_dim=8, spk_dim=6, inter_channels=8, hidden_channels=8,
              filter_channels=12),
    gen=dict(upsample_rates=[4, 4, 2], upsample_kernel_sizes=[8, 8, 4],
             upsample_initial_channel=16, resblock_kernel_sizes=[3, 5],
             resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]]),
)


def _jax_params(seed=0):
    """A JAX SynthesizerInfer param tree (structure from eval_shape, values
    from a numpy seed)."""
    hp = config_from_dict(NARROW)
    model = JSynthesizerInfer(
        ppg_dim=12, vec_dim=8, spk_dim=6, inter_channels=8, hidden_channels=8,
        filter_channels=12, upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
        upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), sampling_rate=3200)
    t = 4
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, 12)), jnp.zeros((1, t, 8)), jnp.full((1, t), 200.0),
        jnp.zeros((1, 6)), jnp.full((1,), t, jnp.int32), jnp.zeros((1, t * 32, 1)),
    )["params"]
    rng = np.random.default_rng(seed)
    return hp, jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_jax_params_inverts_jax_converter():
    hp, params = _jax_params()
    sd = from_jax_params(params)
    _leaves_equal(jconvert.synthesizer_infer(sd), params)
    # every port parameter is covered, with matching shapes
    model = pipeline.build_infer_model(hp, device="cpu")
    model.load_state_dict(sd, strict=True)


def test_load_jax_ckpt_reads_flax_msgpack(tmp_path):
    _, params = _jax_params(1)
    payload = {"model_g": params, "step": 7, "epoch": 2, "hp_raw": "x: 1",
               "scalar": np.float32(0.5)}
    path = tmp_path / "m.ckpt"
    path.write_bytes(serialization.msgpack_serialize(payload))
    got = load_jax_ckpt(str(path))
    assert (got["step"], got["epoch"], got["hp_raw"], got["scalar"]) == (7, 2, "x: 1", 0.5)
    _leaves_equal(got["model_g"], params)


def test_load_svc_model_ckpt_and_pth(tmp_path):
    hp, params = _jax_params(2)
    ckpt = tmp_path / "m.ckpt"
    # a training tree: extra keys (enc_q, emb_g) are ignored by the infer graph
    ckpt.write_bytes(serialization.msgpack_serialize(
        {"model_g": {**params, "enc_q": {"pre": {"kernel": np.zeros((1, 2, 3), np.float32)}},
                     "emb_g": {"kernel": np.zeros((2, 2), np.float32)}}}))
    a = pipeline.load_svc_model(str(ckpt), pipeline.build_infer_model(hp, "cpu", seed=5))
    for k, v in from_jax_params(params).items():
        torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)

    pth = tmp_path / "m.pth"
    torch.save({"model_g": {f"module.{k}": v for k, v in a.state_dict().items()},
                "step": 1}, pth)
    b = pipeline.load_svc_model(str(pth), pipeline.build_infer_model(hp, "cpu", seed=6))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
