"""The port's inference CLI from a wave file on the CPU: every feature is
extracted and written, then synthesised; the extracted features are held
against the JAX CLI's `auto_extract` on the same wave and the same
checkpoint files (reference layouts: whisper {dims, model_state_dict} in
float16, a 12-layer hubert-soft state_dict, a CREPE state_dict)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from whisper_vits_svc_tpu.cli import inference as jcli
from whisper_vits_svc_tpu.models import crepe as jcrepe
from whisper_vits_svc_tpu.models import whisper as jwhisper
from whisper_vits_svc_tpu_torch.cli import inference as cli
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import build_index
from whisper_vits_svc_tpu_torch.models import crepe, hubert, whisper
from whisper_vits_svc_tpu_torch.utils.audio_io import load_wav, save_wav
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict, load_config

N_STATE = 32  # the whisper stand-in's width, the synthesizer's ppg_dim
WAVE_SR = 22050
WAVE_SECONDS = 2.0


def _hp():
    return config_from_dict(dict(
        data=dict(sampling_rate=3200, hop_length=8),
        vits=dict(ppg_dim=N_STATE, vec_dim=256, spk_dim=16, inter_channels=8,
                  hidden_channels=8, filter_channels=16, enc_p_layers=1, flow_wn_layers=1,
                  n_flows=1),
        gen=dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                 upsample_initial_channel=8, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1]])))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Checkpoints, config, speaker vector and a 22.05 kHz song, written
    once for the module."""
    root = tmp_path_factory.mktemp("audio_in")
    torch.manual_seed(0)
    enc = whisper.WhisperEncoder(n_state=N_STATE, n_head=4, n_layer=2)
    msd = {f"encoder.{k}": v.half() for k, v in enc.state_dict().items()}
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=N_STATE, n_audio_head=4,
                n_audio_layer=2)
    torch.save({"dims": dims, "model_state_dict": msd}, root / "whisper.pt")
    torch.save(hubert.HubertSoft().state_dict(), root / "hubert.pt")
    tiny = crepe.Crepe("tiny")
    with torch.no_grad():
        tiny.classifier.weight.mul_(8.0)
    torch.save(tiny.state_dict(), root / "crepe_tiny.pth")
    hp = _hp()
    (root / "c.yaml").write_text(yaml.safe_dump({k: dict(v) for k, v in hp.items()}))
    (root / "c.json").write_text(json.dumps({k: dict(v) for k, v in hp.items()}))
    model = pipeline.build_infer_model(hp, device="cpu", seed=3)
    torch.save({"model_g": model.state_dict()}, root / "m.pth")
    rng = np.random.default_rng(0)
    np.save(root / "s.npy", rng.standard_normal(16).astype(np.float32))
    n = int(WAVE_SECONDS * WAVE_SR)
    f0 = np.linspace(180.0, 320.0, n)
    song = 0.4 * np.sin(2 * np.pi * np.cumsum(f0) / WAVE_SR) + 0.01 * rng.standard_normal(n)
    save_wav(str(root / "song.wav"), song, WAVE_SR)
    return root


def _argv(root, *extra):
    return ["--config", str(root / "c.yaml"), "--model", str(root / "m.pth"),
            "--spk", str(root / "s.npy"), "--wave", str(root / "song.wav"),
            "--whisper-ckpt", str(root / "whisper.pt"), "--hubert-ckpt", str(root / "hubert.pt"),
            "--crepe-ckpt", str(root / "crepe_tiny.pth"), *extra]


def test_cli_from_wave_matches_jax_extraction(files, tmp_path, monkeypatch):
    """The port CLI extracts and writes svc_tmp.{ppg,vec}.npy and
    svc_tmp.pit.csv, then writes 16-bit WAVs of frames * hop samples. The
    JAX CLI's auto_extract on the same files (CREPE read as "tiny", the
    capacity of the file, which the port reads from the weights): the
    soft units within 1e-4 / 1e-5 (12 float32 layers) and the same F0
    CSV. The mel noise of the JAX CLI comes from jax.random and cannot be
    matched, so the PPG path is compared at rng=None (1e-4), and the port's
    written PPG is its pred_ppg with the CLI's seeded generator."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    monkeypatch.chdir(port_dir)
    cli.main(_argv(files, "--device", "cpu"))
    for name in ("svc_tmp.ppg.npy", "svc_tmp.vec.npy", "svc_tmp.pit.csv", "svc_out.wav",
                 "svc_out_pit.wav"):
        assert os.path.isfile(name), name
    ppg, vec = np.load("svc_tmp.ppg.npy"), np.load("svc_tmp.vec.npy")
    pit = pipeline.load_csv_pitch("svc_tmp.pit.csv")
    assert ppg.shape == (100, N_STATE) and vec.shape == (100, 256) and pit.shape == (202,)
    sr, out = wavfile.read("svc_out.wav")
    assert (sr, out.dtype, out.shape) == (3200, np.int16, (200 * 8,))
    assert np.abs(out).max() > 0

    monkeypatch.chdir(jax_dir)
    real_load_crepe = jcrepe.load_crepe
    monkeypatch.setattr(jcrepe, "load_crepe", lambda p: real_load_crepe(p, "tiny"))
    jargs = jcli.build_argparser().parse_args(_argv(files))
    jcli.auto_extract(jargs)
    np.testing.assert_allclose(vec, np.load("svc_tmp.vec.npy"), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pit, pipeline.load_csv_pitch("svc_tmp.pit.csv"))

    audio16, _ = load_wav(str(files / "song.wav"), target_sr=16000)
    port_enc = whisper.load_whisper_encoder(str(files / "whisper.pt"), device="cpu")
    jm, jp = jwhisper.load_whisper_encoder(str(files / "whisper.pt"))
    np.testing.assert_allclose(whisper.pred_ppg(port_enc, audio16, rng=None),
                               jwhisper.pred_ppg(jm, jp, audio16, rng=None),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        ppg, whisper.pred_ppg(port_enc, audio16, rng=torch.Generator().manual_seed(0)))


def test_cli_reuses_features_and_blends_with_banks(files, tmp_path, monkeypatch):
    """A second run in the same directory reuses the svc_tmp.* files (its
    extractor checkpoints do not exist) and reads its config from JSON (no
    PyYAML needed; the same tree as the YAML), and --enable-retrieval blends
    with banks the port's build_index wrote from those features: another
    waveform of the same length. The banks hold the extracted features
    moved by noise, a stand-in for another utterance of the speaker (a
    bank holding the query itself blends it into itself)."""
    monkeypatch.chdir(tmp_path)
    cli.main(_argv(files, "--device", "cpu"))
    first = wavfile.read("svc_out.wav")[1]
    stamps = {n: os.path.getmtime(n) for n in cli.TMP_FEATURES.values()}
    rng = np.random.default_rng(1)
    for key in ("ppg", "vec"):
        feats = np.load(f"svc_tmp.{key}.npy")
        np.save(f"train.{key}.npy", feats + rng.standard_normal(feats.shape).astype(np.float32))
    build_index(["train.ppg.npy"], "spk_whisper.npz")
    build_index(["train.vec.npy"], "spk_hubert.npz")
    argv = _argv(files, "--device", "cpu", "--enable-retrieval",
                 "--retrieval-index-prefix", "spk_", "--retrieval-ratio", "0.9",
                 "--out", "blend.wav")
    for flag in ("--whisper-ckpt", "--hubert-ckpt", "--crepe-ckpt"):
        argv[argv.index(flag) + 1] = "missing.pt"
    argv[argv.index("--config") + 1] = str(files / "c.json")
    assert (load_config(str(files / "c.json")) | {"raw": ""}
            == load_config(str(files / "c.yaml")) | {"raw": ""})
    cli.main(argv)
    assert {n: os.path.getmtime(n) for n in stamps} == stamps
    blend = wavfile.read("blend.wav")[1]
    assert blend.shape == first.shape
    assert np.abs(blend.astype(np.int32) - first).max() > 0


@pytest.mark.parametrize("engine", ["salience", "swipe", "yin", "pyin", "dio", "praat"])
def test_cli_f0_engine_matches_jax_auto_extract(engine, files, tmp_path, monkeypatch):
    """--f0-engine <engine> at --device cpu, the PPG and units given: the
    port CLI's svc_tmp.pit.csv equals the JAX CLI's auto_extract on the
    same wave (integer Hz, the reference's CSV)."""
    rng = np.random.default_rng(6)
    np.save(tmp_path / "ppg.npy", rng.standard_normal((100, N_STATE)).astype(np.float32))
    np.save(tmp_path / "vec.npy", rng.standard_normal((100, 256)).astype(np.float32))
    given = ("--ppg", str(tmp_path / "ppg.npy"), "--vec", str(tmp_path / "vec.npy"),
             "--f0-engine", engine)
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "port")
    cli.main(_argv(files, "--device", "cpu", *given))
    assert os.path.isfile("svc_out.wav")
    pit = pipeline.load_csv_pitch("svc_tmp.pit.csv")
    monkeypatch.chdir(tmp_path / "jax")
    jcli.auto_extract(jcli.build_argparser().parse_args(_argv(files, *given)))
    np.testing.assert_array_equal(pit, pipeline.load_csv_pitch("svc_tmp.pit.csv"))
    assert len(pit) >= 180 and (pit > 0).mean() > 0.5
