"""The port's torch.export serving artifacts (infer/serving.py) and the export
CLI (cli/export.py), on the CPU: the synthesis artifact at micro_hp through
export, save, load and call equals build_synthesis_fn exactly and repeats
for a seed; with zero noise it equals the JAX package's model.apply at
noise_scale=0 within 1e-4 (the tolerance of tests/test_torch_pipeline.py);
the extractor artifacts (CREPE tiny, a one-layer HuBERT, a narrow whisper)
equal their modules; cli.export --device cpu from a port `.pth` and from a
JAX `.ckpt` writes the keys of JAX's export_inference."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.train import checkpoint as jckpt
from whisper_vits_svc_tpu.utils.testing import micro_hp, tiny_hp
from whisper_vits_svc_tpu_torch.cli import export as cli_export
from whisper_vits_svc_tpu_torch.infer import pipeline, serving
from whisper_vits_svc_tpu_torch.models import crepe as pcrepe
from whisper_vits_svc_tpu_torch.models import hubert as phubert
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params
from whisper_vits_svc_tpu_torch.train import checkpoint as ckpt
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

B, T = 1, 24


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """micro_hp's JAX infer graph with perturbed params, the port with the
    same weights, its artifact (written and loaded back) and the inputs."""
    hp = micro_hp()
    jmodel = jpipeline.build_infer_model(hp, pallas_snake=False)
    hop = hp.data.hop_length
    rng = np.random.default_rng(1234)
    inputs = dict(
        ppg=(rng.standard_normal((B, T, hp.vits.ppg_dim)) * 0.1).astype(np.float32),
        vec=(rng.standard_normal((B, T, hp.vits.vec_dim)) * 0.1).astype(np.float32),
        pit=rng.uniform(100, 400, (B, T)).astype(np.float32),
        spk=(rng.standard_normal((B, hp.vits.spk_dim)) * 0.1).astype(np.float32),
        lengths=np.full((B,), T, np.int32),
        source=(rng.standard_normal((B, T * hop, 1)) * 0.1).astype(np.float32))
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *(jnp.asarray(v) for v in inputs.values()))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    port_hp = config_from_dict(hp)
    model = pipeline.build_infer_model(port_hp, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    path = str(tmp_path_factory.mktemp("serving") / "svc_serving.pt2")
    n = serving.export_synthesis(model.state_dict(), port_hp, path, chunk_frames=T, batch=B,
                                 platforms=("cpu",))
    args = tuple(torch.from_numpy(v) for v in inputs.values())
    return hp, jmodel, params, port_hp, model, path, n, inputs, args


def test_synthesis_artifact_round_trip(micro):
    _, _, _, port_hp, model, path, n, _, args = micro
    assert n > 0 and os.path.getsize(path) == n
    fn = serving.load_synthesis(path)
    got = fn(*args, 7)
    want = serving.build_synthesis_fn(model.state_dict(), port_hp, device="cpu")(*args, 7)
    assert got.shape == (B, T * port_hp.data.hop_length, 1) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the same seed repeats exactly, another seed draws other prior noise
    torch.testing.assert_close(fn(*args, 7), got, rtol=0, atol=0)
    assert not torch.equal(fn(*args, 8), got)
    # the eager graph is the model with the seed's noise
    noise = serving.draw_noise(7, (B, T, port_hp.vits.inter_channels), "cpu")
    with torch.no_grad():
        direct = model(*args, 1.0, noise=noise)
    torch.testing.assert_close(got, direct, rtol=0, atol=0)


def test_artifact_keeps_the_snake_operator(tmp_path, monkeypatch):
    """Exported through the card's route (the plain chain standing in for the
    kernel behind svc::snake_alias, as tests/test_torch_snake_bwd.py stands
    it in), an AMP block's graph holds one svc.snake_alias node a SnakeAlias:
    the trace launches nothing, and each call of the loaded artifact
    launches the operator once a snake and gives the eager block's output."""
    from whisper_vits_svc_tpu_torch.nn.amp import AMPBlock
    from whisper_vits_svc_tpu_torch.ops import snake_cuda

    block = AMPBlock(6, 3, (1, 3))
    block.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 6, 150))
                         .astype(np.float32))
    with torch.no_grad():
        want = block(x)

    calls = []

    def fwd(x, alpha, beta):
        calls.append(tuple(x.shape))
        return snake_cuda.snake_alias_fused_cm(x, alpha, beta)

    monkeypatch.setattr(snake_cuda, "snake_alias_cuda", fwd)
    monkeypatch.setattr(snake_cuda, "snake_alias", snake_cuda.snake_alias_kernel)
    routed = str(tmp_path / "routed.pt2")
    serving.export_jitted(block, (x,), routed)
    nodes = [str(n.target) for n in torch.export.load(routed).graph.nodes]
    assert calls == [] and nodes.count("svc.snake_alias.default") == len(block.activations) == 4
    with torch.no_grad():
        got = serving.load_exported(routed)(x)
    assert calls == [(1, 6, 150)] * 4
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_synthesis_artifact_matches_jax_at_zero_noise(micro):
    """The exported program with zero noise is the JAX graph at
    noise_scale=0."""
    hp, jmodel, params, port_hp, _, path, _, inputs, args = micro
    program = serving.load_exported(path)
    zero = torch.zeros(B, T, port_hp.vits.inter_channels)
    with torch.no_grad():
        got = program(*args, zero).numpy()
    apply = jax.jit(jmodel.apply, static_argnums=7)
    want = np.asarray(apply({"params": params}, *(jnp.asarray(v) for v in inputs.values()),
                            0.0, rngs={"noise": jax.random.PRNGKey(0)}))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_device_paths_for_several_platforms(micro, tmp_path):
    """With several platforms each device gets its own file,
    <stem>.<device><suffix>, and the loader takes the one of the device it is
    asked for when the plain path is not there."""
    import shutil

    _, _, _, port_hp, model, path, _, _, args = micro
    dst = str(tmp_path / "svc.pt2")
    assert serving._platform_paths(dst, ("cuda", "cpu")) == [
        ("cuda", str(tmp_path / "svc.cuda.pt2")), ("cpu", str(tmp_path / "svc.cpu.pt2"))]
    assert serving._platform_paths(dst, ("cpu",)) == [("cpu", dst)]
    shutil.copy(path, serving.device_path(dst, "cpu"))
    torch.testing.assert_close(serving.load_synthesis(dst, device="cpu")(*args, 1),
                               serving.load_synthesis(path)(*args, 1), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        serving.load_synthesis(dst, device="cuda")


def test_extractor_artifacts_equal_their_modules(tmp_path):
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    crepe = pcrepe.Crepe("tiny").eval()
    frames = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    path = str(tmp_path / "crepe.pt2")
    assert serving.export_extractor("crepe", crepe, path, batch=4) > 0
    with torch.no_grad():
        want = crepe(pcrepe.normalize_frames(frames))
        torch.testing.assert_close(serving.load_exported(path)(frames), want, rtol=0, atol=0)

    hubert = phubert.HubertSoft(n_layers=1).eval()
    wav = torch.from_numpy((rng.standard_normal((1, 16000)) * 0.1).astype(np.float32))
    hpath = str(tmp_path / "hubert.pt2")
    assert serving.export_jitted(hubert, (torch.zeros(1, 16000),), hpath) > 0
    with torch.no_grad():
        torch.testing.assert_close(serving.load_exported(hpath)(wav), hubert(wav),
                                   rtol=0, atol=0)

    whisper = pwhisper.WhisperEncoder(n_state=64, n_head=4, n_layer=1).eval()
    audio = torch.from_numpy((rng.standard_normal((1, pwhisper.WINDOW_SAMPLES)) * 0.1)
                             .astype(np.float32))
    wpath = str(tmp_path / "whisper.pt2")
    assert serving.export_extractor("whisper", whisper, wpath) > 0
    with torch.no_grad():
        got = serving.load_exported(wpath)(audio)
        want = whisper(pwhisper.log_mel_spectrogram(audio))
    assert got.shape == (1, 750, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown extractor"):
        serving.export_extractor("yin", crepe, path)


JAX_EXPORT_DROPS = ("enc_q", "speaker_classifier", "emb_g")


def test_export_cli_from_port_pth_and_jax_ckpt(tmp_path, monkeypatch):
    """cli.export --device cpu: the inference checkpoint keeps the top-level
    modules JAX's export_inference keeps (read from a JAX `.ckpt` that the
    JAX package writes from the same weights), and loads into the port's
    SynthesizerInfer with every key. The JAX converters read the reference's
    depths, so this runs at tiny_hp."""
    monkeypatch.chdir(tmp_path)
    hp = tiny_hp()
    hp.gen["resblock_dilation_sizes"] = [[1, 3, 5]]  # the JAX converters' depth
    port_hp = config_from_dict(hp)
    g, d = tstep.init_train_states(port_hp, seed=2, device="cpu")
    ckpt.save("trainer.pth", g, d, step=3, epoch=1)
    # the JAX package reads the port's .pth and writes its own .ckpt
    jckpt.export_inference("jax_export.ckpt", jckpt.load_torch_pretrain("trainer.pth")["model_g"])
    keep = set(jckpt.load("jax_export.ckpt")["model_g"])
    assert keep and not keep & set(JAX_EXPORT_DROPS)
    cli_export.main(["--checkpoint", "trainer.pth", "--out", "a.pth", "--device", "cpu"])
    cli_export.main(["--checkpoint", "jax_export.ckpt", "--out", "b.pth", "--device", "cpu"])
    full = g.model.state_dict()
    for out in ("a.pth", "b.pth"):
        sd = torch.load(out, weights_only=True)["model_g"]
        assert {k.split(".")[0] for k in sd} == keep, out
        pipeline.build_infer_model(port_hp, device="cpu", seed=9).load_state_dict(sd, strict=True)
        for k, v in sd.items():
            assert torch.equal(v, full[k]), (out, k)


def test_export_cli_writes_the_bf16_artifact(micro, tmp_path, monkeypatch):
    """--artifact --bf16 with a `.json` config: bfloat16 weights and compute
    baked in, float32 out; equal to build_synthesis_fn(compute_dtype=bf16)
    on the exported weights, and near the float32 graph (the JAX
    package's bf16 bound, tests/test_torch_bf16.py: median abs < 0.05)."""
    hp, _, _, port_hp, model, path, _, _, args = micro
    monkeypatch.chdir(tmp_path)
    torch.save({"model_g": model.state_dict()}, "m.pth")
    (tmp_path / "c.json").write_text(json.dumps(
        {k: dict(v) for k, v in hp.items() if isinstance(v, dict)}))
    cli_export.main(["--checkpoint", "m.pth", "--out", "e.pth", "--device", "cpu", "--bf16",
                     "--artifact", "a.pt2", "--config", "c.json", "--chunk-frames", str(T)])
    got = serving.load_synthesis("a.pt2")(*args, 5)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(
        got, serving.build_synthesis_fn(model.state_dict(), port_hp, compute_dtype=torch.bfloat16,
                                        device="cpu")(*args, 5), rtol=0, atol=0)
    f32 = serving.build_synthesis_fn(model.state_dict(), port_hp, device="cpu")(*args, 5)
    assert float((got - f32).abs().median()) < 0.05
    weights = torch.export.load("a.pt2").state_dict
    assert {v.dtype for v in weights.values() if v.is_floating_point()} == {torch.bfloat16}
    with pytest.raises(SystemExit):
        cli_export.main(["--checkpoint", "m.pth", "--artifact", "a.pt2", "--device", "cpu"])
