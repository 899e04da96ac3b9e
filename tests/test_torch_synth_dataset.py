"""The training-health tools of the port
(whisper_vits_svc_tpu_torch/tools/make_synth_dataset.py, train_health.py,
pitch_debug.py) against the JAX package's tools, loaded by path from
tools/: the same seed writes the same workspace (the same files, wavs equal
byte for byte, the pitch, PPG, vec and speaker caches equal to the bit,
specs within SPEC_REL of their largest value, equal filelists), and
synth_utterance makes the same draws; the trainer CLI trains, validates,
saves and resumes on the port's workspace at a narrow config with
base.yaml's data section and feature widths; the health tool writes its
config and summary; pitch_debug writes the JAX tool's CSV.

The utterances are 1.6-2.0 s: at base.yaml's data section the bucket
sampler keeps only utterances of more than 150 frames (1.5 s)."""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.tools import make_synth_dataset as port_synth
from whisper_vits_svc_tpu_torch.tools import pitch_debug as port_pitch_debug
from whisper_vits_svc_tpu_torch.tools import train_health
from whisper_vits_svc_tpu_torch.train import checkpoint as ckpt
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG

REPO = Path(__file__).resolve().parent.parent
SYNTH_ARGS = ["--n-utts", "12", "--n-speakers", "2", "--seed", "3",
              "--min-secs", "1.6", "--max-secs", "2.0"]
# the port's spec on the CPU against JAX's: float32 sums of the same 1024
# products in another order (measured 5e-7 of the largest value)
SPEC_REL = 1e-5
CACHES = [("pitch", ".pit.npy"), ("whisper", ".ppg.npy"), ("hubert", ".vec.npy"),
          ("speaker", ".spk.npy"), ("singer", ".spk.npy")]


def _jax_tool(name: str):
    """tools/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _narrow_base() -> dict:
    """base.yaml's data section and feature widths (ppg 1280, vec 256, spk
    256), every other width narrow and each element present once."""
    hp = json.loads(json.dumps(BASE_MODEL_CONFIG))
    hp["vits"].update(gin_channels=16, inter_channels=16, hidden_channels=16,
                      filter_channels=32, enc_p_layers=1, enc_q_layers=1, flow_wn_layers=1,
                      n_flows=1)
    hp["gen"].update(upsample_input=16, upsample_initial_channel=32,
                     resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]])
    hp["mpd"].update(periods=[2, 3])
    hp["mrd"].update(resolutions=[[512, 50, 240]])
    return hp


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool("make_synth_dataset").main(["--out", str(root / "jax"), *SYNTH_ARGS])
        rows = port_synth.main(["--out", str(root / "port"), *SYNTH_ARGS, "--device", "cpu"])
    assert len(rows) == 12
    return root / "jax", root / "port"


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_same_files(workspaces):
    jax_ws, port_ws = workspaces
    assert _files(port_ws) == _files(jax_ws)
    assert len(_files(port_ws)) == 12 * 8 + 2 + 2  # 8 files an utterance, singers, lists


def test_wavs_equal_byte_for_byte(workspaces):
    jax_ws, port_ws = workspaces
    wavs = [f for f in _files(jax_ws) if f.endswith(".wav")]
    assert len(wavs) == 36
    for f in wavs:
        assert filecmp.cmp(jax_ws / f, port_ws / f, shallow=False), f


@pytest.mark.parametrize("sub,suffix", CACHES)
def test_caches_equal_to_the_bit(workspaces, sub, suffix):
    jax_ws, port_ws = workspaces
    files = [f for f in _files(jax_ws / "data_svc" / sub) if f.endswith(suffix)]
    assert len(files) == (2 if sub == "singer" else 12)
    for f in files:
        want = np.load(jax_ws / "data_svc" / sub / f)
        got = np.load(port_ws / "data_svc" / sub / f)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, f
        assert np.array_equal(got, want), f


def test_specs_within_float32_rounding(workspaces):
    jax_ws, port_ws = workspaces
    files = [f for f in _files(jax_ws / "data_svc" / "specs")]
    assert len(files) == 12
    for f in files:
        want = np.load(jax_ws / "data_svc" / "specs" / f)
        got = np.load(port_ws / "data_svc" / "specs" / f)
        assert got.dtype == np.float32 and got.shape == want.shape and want.shape[1] == 513
        assert np.abs(got - want).max() <= SPEC_REL * np.abs(want).max(), f


def test_filelists_equal(workspaces):
    jax_ws, port_ws = workspaces
    for name in ("train.txt", "valid.txt"):
        want = (jax_ws / "files" / name).read_text()
        assert (port_ws / "files" / name).read_text() == want
        # relative paths, as the tool writes them from inside the workspace
        assert all(row.startswith("data_svc/waves-32k/") for row in want.splitlines())
    assert len((port_ws / "files" / "valid.txt").read_text().splitlines()) == 6


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_synth_utterance_equal(seed):
    jax_synth = _jax_tool("make_synth_dataset")
    outs = []
    for synth in (jax_synth.synth_utterance, port_synth.synth_utterance):
        rng = np.random.default_rng(seed)
        proj_ppg = (rng.standard_normal((10, 1280)) * 0.3).astype(np.float32)
        proj_vec = (rng.standard_normal((10, 256)) * 0.3).astype(np.float32)
        outs.append(synth(rng, float(rng.uniform(1.0, 2.0)), proj_ppg, proj_vec)
                    + (rng.standard_normal(4),))  # the stream after the utterance
    for want, got in zip(*outs):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    audio, f0, ppg, vec, _ = outs[1]
    assert len(audio) == 320 * len(f0) and ppg.shape == (-(-len(f0) // 2), 1280)
    assert vec.shape == (len(ppg), 256)


def test_trainer_cli_trains_validates_and_resumes(workspaces, tmp_path, monkeypatch):
    """Two steps with one evaluation at a narrow config, a checkpoint at
    step 2, and a resume for one step that continues the counters."""
    ws = tmp_path / "ws"
    shutil.copytree(workspaces[1], ws)
    monkeypatch.chdir(ws)
    hp = train_health.health_config(_narrow_base(), batch_size=2, log=dict(
        info_interval=1, eval_interval=1, save_interval=1, keep_ckpts=0, num_audio=0))
    (ws / "t.json").write_text(json.dumps(hp))
    argv = ["-c", "t.json", "-n", "t", "--device", "cpu"]
    text, div = train_health.run_trainer(argv + ["--max-steps", "2"], out=io.StringIO())
    assert div is None
    traj = train_health.trajectory("logs", "t", text)
    ((val,),) = [traj["validation"]]
    assert (val["step"], val["epoch"]) == (0, 1) and np.isfinite(val["mel"]) and val["mel"] > 0
    assert [(r["step"], r["epoch"]) for r in traj["train"]] == [(1, 1), (2, 1)]
    saved = ckpt.load(os.path.join("chkpt", "t", "t_0001.pth"))
    assert (saved["step"], saved["epoch"]) == (2, 1)

    more, div = train_health.run_trainer(
        argv + ["--max-steps", "3", "-p", "chkpt/t/t_0001.pth"], out=io.StringIO())
    assert div is None
    traj = train_health.trajectory("logs", "t", text + more)
    assert traj["resumed"] == [dict(path="chkpt/t/t_0001.pth", epoch=1, step=2)]
    assert [(r["step"], r["epoch"]) for r in traj["train"]] == [(1, 1), (2, 1), (3, 1)]
    assert all(np.isfinite(r[k]) for r in traj["train"] for k in ("loss_g", "loss_m", "loss_d"))
    resumed = ckpt.load(os.path.join("chkpt", "t", "t_0001.pth"))
    assert (resumed["step"], resumed["epoch"]) == (3, 1)
    # D's AdamW took one more step; G's accumulation went on from the checkpoint
    steps = [{float(s["step"]) for s in p["optim_d"]["state"].values()} for p in (saved, resumed)]
    assert steps == [{2.0}, {3.0}]
    assert (saved["optim_g"]["mini_step"], resumed["optim_g"]["mini_step"]) == (0, 1)


def test_train_health_tool_runs_on_cpu(workspaces, tmp_path):
    """The tool's config (batch 8, the JAX run's log cadence, the loop's NaN
    auto-resume at the JAX run's recovery learning rate, the base config's
    other values kept), its trainer run and its summary, on a copy of the
    port's workspace."""
    ws = tmp_path / "ws"
    shutil.copytree(workspaces[1], ws)
    base = _narrow_base()
    base["train"]["bf16_discriminator"] = True
    (tmp_path / "narrow.json").write_text(json.dumps(base))
    with contextlib.redirect_stdout(io.StringIO()):
        summary = train_health.main(["--ws", str(ws), "--name", "h", "--steps", "2",
                                     "--config", str(tmp_path / "narrow.json"),
                                     "--out", str(tmp_path / "h.json"), "--device", "cpu"])
    cfg = json.loads((ws / "h.json").read_text())
    assert cfg["train"]["batch_size"] == 8 and cfg["train"]["bf16_discriminator"] is True
    assert cfg["train"]["nan_autoresume"] is True
    # r4's recovery: 5e-5 resumed at 2e-5
    assert cfg["train"]["learning_rate"] == 5e-5
    assert cfg["train"]["learning_rate"] * cfg["train"]["nan_lr_factor"] == pytest.approx(2e-5)
    assert {k: cfg["log"][k] for k in train_health.HEALTH_LOG} == train_health.HEALTH_LOG
    assert cfg["data"]["training_files"] == "files/train.txt"
    assert (summary["steps_reached"], summary["nan_guard"], summary["halted"],
            summary["validation"]) == (2, [], None, [])
    assert summary["bf16_discriminator"] is True and summary["batch_size"] == 8
    assert summary["device"] == "cpu" and summary["peak_bytes"] is None
    assert json.loads((tmp_path / "h.json").read_text())["steps_reached"] == 2
    assert ckpt.latest_checkpoint(str(ws / "chkpt" / "h"), "h") is None  # save every 50 epochs


def test_pitch_debug_equals_jax_tool(workspaces, tmp_path):
    jax_ws = workspaces[0]
    pit = next((jax_ws / "data_svc" / "pitch").rglob("*.pit.npy"))
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool("pitch_debug").main(["-p", str(pit), "-o", str(tmp_path / "jax.csv")])
        port_pitch_debug.main(["-p", str(pit), "-o", str(tmp_path / "port.csv")])
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.splitlines()) == len(np.load(pit)) and text.startswith("0m 0s   0,")


def test_tools_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """Both tools refuse to start without CUDA before they write a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for main, argv in ((port_synth.main, ["--out", "ws"]),
                       (port_synth.main, ["--out", "ws", "--device", "cuda"]),
                       (train_health.main, ["--ws", "ws", "--name", "h"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert os.listdir(tmp_path) == []
