"""Weight norm folded once (nn/conv.py::fold_weight_norm) against the JAX
package's fold_weight_norm, and folded against weight-norm models on the
CPU: the generator, svc_infer, the load paths in both directions, HuBERT's
positional conv (its norm over dim 2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer.retrieval import DummyRetrieval as JDummyRetrieval
from whisper_vits_svc_tpu.nn.conv import fold_weight_norm as j_fold_weight_norm
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models import hubert
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params, load_tolerant
from whisper_vits_svc_tpu_torch.nn.conv import Conv1d, Conv2d, ConvTranspose1d, fold_weight_norm
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict


@pytest.fixture(scope="module")
def micro():
    """micro_hp's JAX infer graph with perturbed params, and the port's
    weight-norm and folded models with the same weights."""
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
    folded = pipeline.build_infer_model(port_hp, device="cpu", fold_wn=True)
    folded.load_state_dict(fold_weight_norm(model.state_dict()), strict=True)
    return hp, jmodel, params, port_hp, model, folded


def _features(hp, t, seed=3):
    rng = np.random.default_rng(seed)
    pit = rng.uniform(100, 400, t).astype(np.float32)
    pit[20:31] = 0.0
    return (rng.standard_normal(hp.vits.spk_dim).astype(np.float32), pit,
            (rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
            (rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32))


def test_fold_matches_jax_fold(micro):
    """Every folded kernel of the synthesizer against the JAX package's fold
    of the same tree, converted: the same keys (no weight_g / weight_v left),
    the same values. Both compute g * v / (||v|| + 1e-12) in float32, the
    norm summed in another order: 1e-6 relative to the largest kernel entry."""
    _, _, params, _, model, _ = micro
    ours = fold_weight_norm(model.state_dict())
    ref = from_jax_params(j_fold_weight_norm(params))
    assert sorted(ours) == sorted(ref)
    assert not [k for k in ours if k.endswith(("weight_g", "weight_v"))]
    n_folded = sum(k.endswith("weight_g") for k in model.state_dict())
    assert n_folded > 0 and len(ours) == len(model.state_dict()) - n_folded
    for k in ours:
        scale = float(ref[k].abs().max())
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)


def test_folded_generator_equals_weight_norm(micro):
    """The generator with folded weights computes each kernel once, from the
    same g and v in the same order as the weight-norm module does on each
    call: the same waveform to the bit on the CPU."""
    hp, _, _, _, model, folded = micro
    assert all(not m.weight_norm for m in folded.dec.modules()
               if isinstance(m, (Conv1d, ConvTranspose1d)))
    assert any(m.weight_norm for m in model.dec.modules() if isinstance(m, ConvTranspose1d))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 12, hp.vits.inter_channels)).astype(np.float32))
    spk = torch.from_numpy(rng.standard_normal((2, hp.vits.spk_dim)).astype(np.float32))
    f0 = torch.from_numpy(rng.uniform(100, 300, (2, 12)).astype(np.float32))
    with torch.no_grad():
        har = model.pitch2source(f0)
        a = model.dec(spk, x, har)
        b = folded.dec(spk, x, har)
    assert a.shape == b.shape and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_svc_infer_folded_equals_weight_norm_and_jax(micro):
    """svc_infer with weights folded once against the weight-norm model (to
    the bit) and against the JAX package's svc_infer with weight norm (the
    port's own parity bound, 1e-4 on a tanh waveform, noise_scale=0)."""
    hp, jmodel, params, port_hp, model, folded = micro
    spk, pit, ppg, vec = _features(hp, 90)
    kw = dict(noise_scale=0.0, out_chunk=30, hop_frame=4)
    ref = jpipeline.svc_infer(jmodel, params, JDummyRetrieval(), spk, pit, ppg, vec, hp, **kw)
    wn = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                            device="cpu", **kw)
    out = pipeline.svc_infer(folded, DummyRetrieval(), spk, pit, ppg, vec, port_hp,
                             device="cpu", **kw)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_array_equal(out, wn)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_load_paths_take_either_form(micro, tmp_path):
    """A weight-norm checkpoint loads into a folded model (folded on the way
    in), and a folded one into a weight-norm model (which folds itself
    first), through load_svc_model and through load_state_dict; a folded
    state_dict stays folded."""
    _, _, _, port_hp, model, folded = micro
    wn_sd, folded_sd = model.state_dict(), folded.state_dict()
    torch.save({"model_g": wn_sd}, tmp_path / "wn.pth")
    torch.save({"model_g": folded_sd}, tmp_path / "folded.pth")
    into_folded = pipeline.build_infer_model(port_hp, device="cpu", seed=7, fold_wn=True)
    pipeline.load_svc_model(str(tmp_path / "wn.pth"), into_folded)
    into_wn = pipeline.build_infer_model(port_hp, device="cpu", seed=7)
    pipeline.load_svc_model(str(tmp_path / "folded.pth"), into_wn)
    strict = pipeline.build_infer_model(port_hp, device="cpu", seed=7)
    strict.load_state_dict(folded_sd, strict=True)
    for m in (into_folded, into_wn, strict):
        sd = m.state_dict()
        assert list(sd) == list(folded_sd)
        assert all(torch.equal(sd[k], folded_sd[k]) for k in sd)
    assert fold_weight_norm(folded_sd) == folded_sd
    # a DDP-saved key with the "module." prefix is found too
    again = pipeline.build_infer_model(port_hp, device="cpu", seed=7, fold_wn=True)
    assert load_tolerant(again, {f"module.{k}": v for k, v in wn_sd.items()}) == []
    assert all(torch.equal(v, folded_sd[k]) for k, v in again.state_dict().items())


@pytest.mark.parametrize("module", [
    lambda: Conv1d(3, 5, 3, padding=1, weight_norm=True),
    lambda: Conv1d(3, 1, 7, padding=3, weight_norm=True),  # one output channel
    lambda: ConvTranspose1d(4, 3, 8, stride=4, padding=2),
    lambda: Conv2d(2, 3, (3, 5), (1, 2), (1, 2)),
])
def test_conv_modules_fold(module):
    """Each weight-norm convolution, folded through its state_dict, gives the
    same output to the bit, its parameters a plain `weight` and the bias."""
    g = torch.Generator().manual_seed(0)
    m = module()
    m.init_weights(g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    f = module()
    f.load_state_dict(fold_weight_norm(m.state_dict()))
    assert not f.weight_norm and sorted(n for n, _ in f.named_parameters()) == ["bias", "weight"]
    c = m.weight_v.shape[0] if isinstance(m, ConvTranspose1d) else m.weight_v.shape[1]
    shape = (2, c, 9, 11) if isinstance(m, Conv2d) else (2, c, 17)
    x = torch.randn(shape, generator=g)
    with torch.no_grad():
        assert torch.equal(f(x), m(x))


def test_hubert_positional_conv_folds_over_dim_2():
    """HuBERT's positional conv keeps weight_g per kernel position
    (weight_norm(dim=2)): the fold takes the norm over (O, I/g) there, and
    the folded module gives the same embedding to the bit."""
    torch.manual_seed(0)
    pos = hubert.PositionalConvEmbedding()
    with torch.no_grad():
        pos.conv.weight_g.uniform_(0.5, 1.5)
    sd = fold_weight_norm(pos.state_dict())
    v, gain = pos.conv.weight_v, pos.conv.weight_g
    norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    torch.testing.assert_close(sd["conv.weight"], gain * v / (norm + 1e-12), rtol=0, atol=0)
    folded = hubert.PositionalConvEmbedding()
    folded.load_state_dict(sd)
    x = torch.randn(1, 140, 768)
    with torch.no_grad():
        assert torch.equal(folded(x), pos(x))
