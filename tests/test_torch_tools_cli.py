"""Model merge / average, speaker mixing and the cli.misc entry points of
the port on the CPU, against the JAX package's tools and CLIs on the same
files: merged parameters key by key (bit for bit), the mixed speaker, the
post filter's waveform, the retrieval banks; the shift and batch CLIs
through the port's own synthesis."""

import argparse
import json
import os

import numpy as np
import pytest
import torch
from flax import serialization
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.cli import misc as jmisc
from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer import tools as jtools
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.cli import inference as cli
from whisper_vits_svc_tpu_torch.cli import misc
from whisper_vits_svc_tpu_torch.infer import pipeline, tools
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models import convert, crepe, hubert, whisper
from whisper_vits_svc_tpu_torch.utils.audio_io import save_wav
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

N_STATE = 32


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Three JAX .ckpt files of micro_hp's inference graph (different
    seeds) and the same three as reference .pth files."""
    root = tmp_path_factory.mktemp("merge")
    hp = micro_hp()
    jmodel = jpipeline.build_infer_model(hp)
    t = 8
    init = jax.jit(jmodel.init)
    paths = []
    for seed in range(3):
        params = init(
            {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(9)},
            jnp.zeros((1, t, hp.vits.ppg_dim)), jnp.zeros((1, t, hp.vits.vec_dim)),
            jnp.full((1, t), 200.0), jnp.zeros((1, hp.vits.spk_dim)),
            jnp.full((1,), t, jnp.int32), jnp.zeros((1, t * hp.data.hop_length, 1)),
        )["params"]
        params = jax.tree.map(np.asarray, params)
        ckpt = root / f"m{seed}.ckpt"
        ckpt.write_bytes(serialization.msgpack_serialize({"model_g": params}))
        torch.save({"model_g": convert.from_jax_params(params)}, root / f"m{seed}.pth")
        paths.append(str(ckpt))
    return hp, root, paths


def _same(sd, tree):
    want = convert.from_jax_params(tree)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("ext", [".ckpt", ".pth"])
def test_merge_and_average_equal_jax(ckpts, ext, tmp_path):
    """A JAX .ckpt or a reference .pth in; the merged and the averaged
    parameters equal the JAX package's merge and average of the same
    models, key by key, bit for bit; the written .pth loads into
    build_infer_model and synthesises."""
    hp, root, paths = ckpts
    inputs = [p.replace(".ckpt", ext) for p in paths]
    merged = tools.merge_model(inputs[0], inputs[1], str(tmp_path / "merged.pth"), ratio=0.3)
    _same(merged, jtools.merge_model(paths[0], paths[1], str(tmp_path / "j.ckpt"), ratio=0.3))
    avg = tools.average_model(inputs, str(tmp_path / "avg.pth"))
    _same(avg, jtools.average_model(paths, str(tmp_path / "javg.ckpt")))

    port_hp = config_from_dict(hp)
    model = pipeline.build_infer_model(port_hp, device="cpu")
    pipeline.load_svc_model(str(tmp_path / "merged.pth"), model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), merged[k].numpy())
    rng = np.random.default_rng(0)
    audio = pipeline.svc_infer(model, DummyRetrieval(), rng.standard_normal(16), np.full(20, 200.0),
                               rng.standard_normal((20, hp.vits.ppg_dim)),
                               rng.standard_normal((20, hp.vits.vec_dim)), port_hp,
                               device="cpu")
    assert audio.shape == (20 * hp.data.hop_length,) and np.isfinite(audio).all()


def test_merge_and_eva_clis_equal_jax(ckpts, tmp_path, monkeypatch):
    """`cli.misc merge` (two models, and --models for the average) and
    `cli.misc eva` against the JAX CLIs on the same files."""
    _, root, paths = ckpts
    monkeypatch.chdir(tmp_path)
    misc.main(["merge", "--model1", paths[0], "--model2", paths[1], "--ratio", "0.7",
               "--out", "m.pth"])
    jmisc.merge_main(["--model1", paths[0], "--model2", paths[1], "--ratio", "0.7",
                      "--out", "m.ckpt"])
    _same(torch.load("m.pth", weights_only=True)["model_g"],
          serialization.msgpack_restore(open("m.ckpt", "rb").read())["model_g"])
    misc.main(["merge", "--model1", paths[0], "--models", paths[1], paths[2], "--out", "a.pth"])
    jmisc.merge_main(["--model1", paths[0], "--models", paths[1], paths[2], "--out", "a.ckpt"])
    _same(torch.load("a.pth", weights_only=True)["model_g"],
          serialization.msgpack_restore(open("a.ckpt", "rb").read())["model_g"])

    rng = np.random.default_rng(1)
    for i in range(3):
        np.save(f"s{i}.npy", rng.standard_normal(256).astype(np.float32))
    argv = ["--spk", "s0.npy", "s1.npy", "s2.npy", "--weights", "0.2", "0.5", "0.3"]
    misc.main(["eva", *argv, "--out", "eva.npy"])
    jmisc.eva_main([*argv, "--out", "jeva.npy"])
    np.testing.assert_array_equal(np.load("eva.npy"), np.load("jeva.npy"))
    np.testing.assert_array_equal(
        tools.mix_speakers(["s0.npy", "s1.npy"], [0.4, 0.6]),
        jtools.mix_speakers(["s0.npy", "s1.npy"], [0.4, 0.6]))


def test_post_cli_equals_jax(tmp_path, monkeypatch):
    """`cli.misc post` at --device cpu without a silero file (the energy
    VAD, as the JAX CLI falls back): the same 16-bit waveform."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    t = np.arange(3 * 16000) / 16000
    ref = 0.3 * np.sin(2 * np.pi * 220 * t) * ((t % 1.0) > 0.4) + 0.002 * rng.standard_normal(t.size)
    save_wav("ref.wav", ref, 16000)
    save_wav("svc.wav", 0.3 * rng.standard_normal(2 * t.size), 32000)
    argv = ["--ref", "ref.wav", "--svc", "svc.wav", "--vad-model", "missing.jit"]
    misc.main(["post", *argv, "--out", "p.wav", "--device", "cpu"])
    jmisc.inference_post_main([*argv, "--out", "j.wav"])
    got, want = wavfile.read("p.wav"), wavfile.read("j.wav")
    assert got[0] == want[0] == 32000
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] == 0).mean() > 0.2  # non-speech muted


def test_train_retrieval_cli_equals_jax(tmp_path, monkeypatch):
    """`cli.misc train-retrieval`: one bank per speaker and feature, equal to
    the JAX CLI's (a speaker over the compression threshold is clustered
    with the same seed)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    for feat, dim in (("whisper", 12), ("hubert", 8)):
        for spk, n in (("a", 2), ("b", 3)):
            os.makedirs(f"data_svc/{feat}/{spk}")
            for i in range(n):
                np.save(f"data_svc/{feat}/{spk}/{i}.npy",
                        rng.standard_normal((40, dim)).astype(np.float32))
    argv = ["--base-dir", "data_svc", "--compress-threshold", "100", "--n-clusters", "16"]
    misc.main(["train-retrieval", *argv, "--out-dir", "port"])
    jmisc.train_retrieval_main([*argv, "--out-dir", "jax"])
    for spk in ("a", "b"):
        for feat in ("whisper", "hubert"):
            got = np.load(f"port/{spk}/{feat}.npz")["bank"]
            np.testing.assert_array_equal(got, np.load(f"jax/{spk}/{feat}.npz")["bank"])
            assert got.shape[0] == (80 if spk == "a" else 16)


def _tiny_hp():
    return config_from_dict(dict(
        data=dict(sampling_rate=3200, hop_length=8),
        vits=dict(ppg_dim=N_STATE, vec_dim=256, spk_dim=16, inter_channels=8,
                  hidden_channels=8, filter_channels=16, enc_p_layers=1, flow_wn_layers=1,
                  n_flows=1),
        gen=dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                 upsample_initial_channel=8, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1]])))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A tiny synthesizer (.pth), its JSON config, a speaker vector and
    precomputed features for 60 frames."""
    root = tmp_path_factory.mktemp("synth")
    hp = _tiny_hp()
    (root / "c.json").write_text(json.dumps({k: dict(v) for k, v in hp.items()}))
    torch.save({"model_g": pipeline.build_infer_model(hp, device="cpu", seed=4).state_dict()},
               root / "m.pth")
    rng = np.random.default_rng(4)
    np.save(root / "s.npy", rng.standard_normal(16).astype(np.float32))
    np.save(root / "ppg.npy", rng.standard_normal((30, N_STATE)).astype(np.float32))
    np.save(root / "vec.npy", rng.standard_normal((30, 256)).astype(np.float32))
    pipeline.save_csv_pitch(np.full(60, 200.0), str(root / "pit.csv"))
    return hp, root


def test_shift_cli_writes_each_shift(synth, tmp_path, monkeypatch):
    """`cli.misc shift --shift_l -1 --shift_r 1 --device cpu`: one waveform
    per shift, each the port's svc_infer of the shifted pitch."""
    hp, root = synth
    monkeypatch.chdir(tmp_path)
    misc.main(["shift", "--config", str(root / "c.json"), "--model", str(root / "m.pth"),
               "--spk", str(root / "s.npy"), "--ppg", str(root / "ppg.npy"),
               "--vec", str(root / "vec.npy"), "--pit", str(root / "pit.csv"),
               "--shift_l", "-1", "--shift_r", "1", "--device", "cpu"])
    model = pipeline.build_infer_model(hp, device="cpu")
    pipeline.load_svc_model(str(root / "m.pth"), model)
    ppg = np.repeat(np.load(root / "ppg.npy"), 2, 0)
    vec = np.repeat(np.load(root / "vec.npy"), 2, 0)
    for shift in (-1, 0, 1):
        sr, out = wavfile.read(f"svc_out_{shift}.wav")
        pit = pipeline.shift_pitch(pipeline.load_csv_pitch(str(root / "pit.csv")), shift)
        want = pipeline.svc_infer(model, DummyRetrieval(), np.load(root / "s.npy"), pit, ppg,
                                  vec, hp, device="cpu")
        assert sr == 3200 and out.shape == want.shape
        np.testing.assert_allclose(out / 32767.0, want, atol=2 / 32767.0)


def test_batch_cli_runs_every_wave(synth, tmp_path, monkeypatch):
    """`cli.misc batch --device cpu` on a folder of two waves: each goes
    through the inference CLI from the wave, with the checkpoint paths of
    the JAX batch CLI (crepe_pretrain/full.pth, not the inference CLI's
    crepe/assets/full.pth), its svc_tmp.* files removed first."""
    hp, root = synth
    monkeypatch.chdir(tmp_path)
    os.makedirs("songs")
    rng = np.random.default_rng(5)
    for name, f in (("a.wav", 180.0), ("b.wav", 260.0)):
        t = np.arange(16000) / 16000
        save_wav(f"songs/{name}", 0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(t.size),
                 16000)
    os.makedirs("whisper_pretrain")
    enc = whisper.WhisperEncoder(n_state=N_STATE, n_head=4, n_layer=2)
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=N_STATE, n_audio_head=4,
                n_audio_layer=2)
    torch.save({"dims": dims, "model_state_dict": {f"encoder.{k}": v
                                                   for k, v in enc.state_dict().items()}},
               "whisper_pretrain/large-v2.pt")
    os.makedirs("crepe_pretrain")
    torch.save(crepe.Crepe("tiny").state_dict(), "crepe_pretrain/full.pth")
    asked = []
    small = hubert.HubertSoft(n_layers=1).eval()
    monkeypatch.setattr(hubert, "load_hubert_soft", lambda p, d: asked.append(p) or small)
    real_load_crepe = crepe.load_crepe
    monkeypatch.setattr(crepe, "load_crepe",
                        lambda p, **kw: asked.append(p) or real_load_crepe(p, **kw))
    misc.main(["batch", "--config", str(root / "c.json"), "--model", str(root / "m.pth"),
               "--folder", "songs", "--spk", str(root / "s.npy"), "--out", "out",
               "--device", "cpu"])
    assert asked == ["hubert_pretrain/hubert-soft-0d54a1f4.pt", "crepe_pretrain/full.pth"] * 2
    for name in ("a.wav", "b.wav"):
        sr, out = wavfile.read(f"out/{name}")
        assert sr == 3200 and out.shape == (100 * hp.data.hop_length,)
        assert np.abs(out).max() > 0


def test_misc_main_names_its_entry_points():
    assert sorted(misc.ENTRY_POINTS) == ["batch", "eva", "merge", "post", "shift",
                                         "train-retrieval"]
    with pytest.raises(SystemExit, match="usage"):
        misc.main(["nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            misc.main(["post", "--ref", "r.wav", "--svc", "s.wav"])
    assert isinstance(cli.build_argparser().parse_args(
        ["--config", "c", "--model", "m", "--spk", "s", "--bf16"]), argparse.Namespace)
