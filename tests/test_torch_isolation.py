"""The port stands alone: it imports no JAX, flax or JAX-package module (nor,
at import time, yaml, msgpack, matplotlib or tensorboard, which the card's
machine lacks), and its entry points refuse to run without CUDA unless asked
for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.cli import inference as cli
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import ast, importlib, pkgutil, sys
import whisper_vits_svc_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
# chip_smoke.py's own imports, without running it
tree = ast.parse(open("chip_smoke.py").read())
for node in tree.body:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "whisper_vits_svc_tpu",
                                    "yaml", "msgpack", "matplotlib", "tensorboard",
                                    "tensorboardX")
             or n == "torch.utils.tensorboard")
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # the prefix trap: whisper_vits_svc_tpu_torch starts with whisper_vits_svc_tpu,
    # so modules are matched on their first dotted component
    assert res.stdout.strip().splitlines()[-1] == "BAD []", res.stdout


def test_kernel_modules_and_sources_stand_alone():
    """The kernel wrappers (the snake's variants and the fused AMP iteration
    among them) are modules of the package the probe above imports, and no
    source under csrc/ or program file of the port names JAX, flax or the
    JAX package in an import or include."""
    import re

    pkg = os.path.join(REPO, "whisper_vits_svc_tpu_torch")
    for module in ("ops/cuda_build.py", "utils/counters.py",
                   "ops/snake_cuda.py", "ops/amp_cuda.py", "ops/viterbi_cuda.py",
                   "ops/crepe_conv_cuda.py", "nn/amp.py",
                   "nn/snake.py", "tools/crepe_conv_probe.py", "ops/stft.py", "models/f0_alt.py",
                   "models/salience.py", "models/swipe.py", "models/dio.py", "models/praat.py",
                   "models/silero_vad.py", "infer/post.py", "infer/tools.py", "cli/misc.py",
                   "infer/stream.py", "infer/stream_extract.py", "parallel/ddp.py",
                   "utils/rng.py", "data/preprocess.py", "cli/preprocessing.py",
                   "infer/serving.py", "cli/export.py", "cli/webui.py", "parallel/sharding.py",
                   "utils/profiling.py", "utils/device_trace.py", "models/discriminator.py",
                   "nn/conv.py", "tools/make_synth_dataset.py", "tools/pitch_debug.py",
                   "tools/train_health.py"):
        assert os.path.isfile(os.path.join(pkg, module)), module
    bad = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|whisper_vits_svc_tpu)(?:\.|\s|$)",
                     re.M)
    checked = 0
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(root, name), encoding="utf-8").read()
                assert not bad.search(text), os.path.join(root, name)
                assert "torch/extension.h" not in text, name
                checked += 1
    assert not bad.search(open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8").read())
    assert checked >= 48


def test_entry_points_keep_the_default_kernels(monkeypatch):
    """The two switches of build_infer_model default to the direct snake
    kernel and the unfused AMP blocks, and reach every block when set."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = _tiny_hp()
    model = pipeline.build_infer_model(hp, device="cpu")
    assert all(not b.fused_iter for b in model.dec.resblocks)
    assert {m.variant for m in model.modules() if hasattr(m, "variant")} == {"direct"}
    alt = pipeline.build_infer_model(hp, device="cpu", snake_variant="mma", amp_fused_iter=True)
    assert all(b.fused_iter for b in alt.dec.resblocks)
    assert {m.variant for m in alt.modules() if hasattr(m, "variant")} == {"mma"}
    assert list(alt.state_dict()) == list(model.state_dict())
    # fast_edges: every snake zero-padded and plain, the fused AMP iteration
    # off (its kernel has exact edges only), the same parameters
    assert {m.exact_edges for m in model.modules() if hasattr(m, "exact_edges")} == {True}
    fast = pipeline.build_infer_model(hp, device="cpu", fast_edges=True, amp_fused_iter=True)
    assert {m.exact_edges for m in fast.modules() if hasattr(m, "exact_edges")} == {False}
    assert all(not b.fused_iter for b in fast.dec.resblocks)
    assert list(fast.state_dict()) == list(model.state_dict())
    # the serving artifact's graph is the default one: every snake on the
    # direct kernel with exact edges (through svc::snake_alias on the card)
    from whisper_vits_svc_tpu_torch.infer import serving

    graph = serving._synthesis_graph(model.state_dict(), hp, None, torch.device("cpu"))
    assert {(m.variant, m.exact_edges) for m in graph.modules()
            if hasattr(m, "variant")} == {("direct", True)}


def test_new_modules_run_without_jax():
    """The profiling hooks, the device-trace readers, the weight-norm fold and
    the mel discriminator run in a process with jax, flax and the JAX package
    made unimportable."""
    probe = r"""
import sys
for name in ("jax", "jaxlib", "flax", "whisper_vits_svc_tpu"):
    sys.modules[name] = None
import tempfile
import torch
from whisper_vits_svc_tpu_torch.infer.pipeline import source2wav
from whisper_vits_svc_tpu_torch.models.discriminator import MelspecDiscriminator
from whisper_vits_svc_tpu_torch.nn.conv import Conv1d, fold_weight_norm
from whisper_vits_svc_tpu_torch.utils import device_trace
from whisper_vits_svc_tpu_torch.utils.profiling import StepTimer, annotate, trace
c = Conv1d(2, 3, 3, weight_norm=True)
c.init_weights(torch.Generator().manual_seed(0))
f = Conv1d(2, 3, 3, weight_norm=True)
f.load_state_dict(fold_weight_norm(c.state_dict()))
x = torch.randn(1, 2, 9)
assert torch.equal(f(x), c(x)) and not f.weight_norm
m = MelspecDiscriminator().eval()
m.init_weights(torch.Generator().manual_seed(0))
((fmap, score),) = m(torch.randn(1, 24000, 1))
assert score.shape == (1,) and len(fmap) == 4
with tempfile.TemporaryDirectory() as d:
    with trace(d), annotate("r"):
        t = StepTimer(2)
        t.start()
        t.stop(x)
    assert device_trace.device_ms_per_call(d, "snake_alias") is None
assert source2wav(x.numpy()).dtype.name == "int16"
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK", res.stdout


def test_tool_modules_stand_alone():
    """The training-health tools (make_synth_dataset, pitch_debug,
    train_health) import no JAX, no JAX-package module and nothing of the
    repository's root tools/, and run with all of them made unimportable
    (an import of any raises):
    a two-utterance workspace on the CPU and its first pitch cache as CSV."""
    import ast

    for name in ("make_synth_dataset", "pitch_debug", "train_health"):
        path = os.path.join(REPO, "whisper_vits_svc_tpu_torch", "tools", f"{name}.py")
        tree = ast.parse(open(path, encoding="utf-8").read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
        assert not roots & {"jax", "jaxlib", "flax", "whisper_vits_svc_tpu", "tools"}, name
    probe = r"""
import glob, importlib.abc, io, contextlib, os, sys, tempfile
BLOCKED = ("jax", "jaxlib", "flax", "whisper_vits_svc_tpu", "tools")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, Block())
from whisper_vits_svc_tpu_torch.tools import make_synth_dataset, pitch_debug, train_health
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    rows = make_synth_dataset.main(["--out", d, "--n-utts", "2", "--n-speakers", "1",
                                    "--min-secs", "1.6", "--max-secs", "1.7",
                                    "--device", "cpu"])
    pit = sorted(glob.glob(os.path.join(d, "data_svc", "pitch", "*", "*.pit.npy")))[0]
    pitch_debug.main(["-p", pit, "-o", os.path.join(d, "p.csv")])
    assert len(rows) == 2 and os.path.getsize(os.path.join(d, "p.csv")) > 0
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK", res.stdout


def test_build_infer_model_folds_only_when_asked(monkeypatch):
    """build_infer_model keeps weight norm by default; fold_wn=True folds
    every pair into a plain kernel and keeps the kernels' switches."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = _tiny_hp()
    model = pipeline.build_infer_model(hp, device="cpu")
    assert any(k.endswith("weight_g") for k in model.state_dict())
    folded = pipeline.build_infer_model(hp, device="cpu", fold_wn=True, snake_variant="mma")
    assert not any(k.endswith(("weight_g", "weight_v")) for k in folded.state_dict())
    assert {m.variant for m in folded.modules() if hasattr(m, "variant")} == {"mma"}


def _tiny_hp():
    return config_from_dict(dict(
        data=dict(sampling_rate=3200, hop_length=8),
        vits=dict(ppg_dim=4, vec_dim=4, spk_dim=4, inter_channels=4, hidden_channels=4,
                  filter_channels=8, enc_p_layers=1, flow_wn_layers=1, n_flows=1),
        gen=dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                 upsample_initial_channel=8, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1]])))


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = _tiny_hp()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.build_infer_model(hp)
    model = pipeline.build_infer_model(hp, device="cpu")
    z = np.zeros((5, 4), np.float32)
    args = (model, DummyRetrieval(), np.zeros(4, np.float32), np.full(5, 200.0, np.float32),
            z, z, hp)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.svc_infer(*args, device=device)
    assert pipeline.svc_infer(*args, device="cpu").shape == (40,)


def test_trainer_cli_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """The trainer CLI refuses to start without CUDA; with --device cpu it
    checks the hop, seeds numpy and hands its flags to train()."""
    import yaml

    from whisper_vits_svc_tpu_torch.cli import trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = {k: dict(v) for k, v in _tiny_hp().items()}
    hp["train"] = {"seed": 77}
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(hp))
    calls = []
    monkeypatch.setattr(trainer, "train", lambda *a, **k: calls.append((a, k)))
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.main(["-c", str(cfg), "-n", "t", *extra])
    assert calls == []
    with pytest.raises(AssertionError, match="hop_length must be 320"):
        trainer.main(["-c", str(cfg), "-n", "t", "--device", "cpu"])
    hp["data"]["hop_length"] = 320
    cfg.write_text(yaml.safe_dump(hp))
    trainer.main(["-c", str(cfg), "-n", "t", "-p", "x.pth", "--max-steps", "4",
                  "--device", "cpu"])
    ((args, kwargs),) = calls
    assert args[1:] == ("t", "x.pth", None, 4)
    assert kwargs["device"] == torch.device("cpu") and kwargs["profile_dir"] is None
    assert args[0].train.seed == 77 and args[0].raw == cfg.read_text()
    assert np.random.get_state()[1][0] == np.random.RandomState(77).get_state()[1][0]


def test_cli_requires_precomputed_features(tmp_path, monkeypatch):
    """Without --wave the CLI needs every feature precomputed: a missing one
    (with no svc_tmp.* file to reuse) stops it before any checkpoint is
    read."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--wave is needed to extract --vec, --pit"):
        cli.main(["--config", "c.yaml", "--model", "m.ckpt", "--spk", "s.npy",
                  "--ppg", "p.npy", "--device", "cpu"])


def test_cli_wave_path_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """From --wave the CLI refuses to start without CUDA, before it reads the
    wave or a checkpoint or writes a feature; every extractor loader and the
    retrieval banks refuse as well."""
    from whisper_vits_svc_tpu_torch.infer import retrieval
    from whisper_vits_svc_tpu_torch.models import crepe, hubert, speaker_encoder, whisper

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", "c.yaml", "--model", "m.pth", "--spk", "s.npy", "--wave", "w.wav"]
    for extra in ([], ["--device", "cuda"], ["--enable-retrieval"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv + extra)
    assert os.listdir(tmp_path) == []
    for load in (whisper.load_whisper_encoder, hubert.load_hubert_soft, crepe.load_crepe,
                 speaker_encoder.load_speaker_encoder):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load("missing.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        retrieval.ArrayIndexRetrieval(np.zeros((2, 4)), np.zeros((2, 4)), 0.5, 1)


def test_cli_converts_on_cpu(tmp_path, monkeypatch):
    """The CLI end to end on the CPU: .pth weights, 320-hop features
    (repeated x2), a pitch CSV; writes 16-bit WAVs of frames * hop samples."""
    import yaml
    from scipy.io import wavfile

    monkeypatch.chdir(tmp_path)
    hp = _tiny_hp()
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(
        {k: dict(v) for k, v in hp.items()}))
    model = pipeline.build_infer_model(hp, device="cpu", seed=3)
    torch.save({"model_g": model.state_dict()}, tmp_path / "m.pth")
    rng = np.random.default_rng(0)
    np.save(tmp_path / "s.npy", rng.standard_normal(4).astype(np.float32))
    np.save(tmp_path / "p.npy", rng.standard_normal((12, 4)).astype(np.float32))
    np.save(tmp_path / "v.npy", rng.standard_normal((12, 4)).astype(np.float32))
    pipeline.save_csv_pitch(np.full(24, 220.0), str(tmp_path / "f0.csv"))
    cli.main(["--config", "c.yaml", "--model", "m.pth", "--spk", "s.npy", "--ppg", "p.npy",
              "--vec", "v.npy", "--pit", "f0.csv", "--shift", "2", "--out", "o.wav",
              "--device", "cpu"])
    for name in ("o.wav", "svc_out_pit.wav"):
        sr, audio = wavfile.read(tmp_path / name)
        assert (sr, audio.dtype, audio.shape) == (3200, np.int16, (24 * 8,))


def test_streaming_and_ddp_need_cuda_unless_asked_for_cpu(monkeypatch):
    """StreamingSvc, the streaming extractors, the offline Viterbi decode and
    the data-parallel set-up (and the loop through it) refuse to run without
    CUDA unless asked for the CPU, before any rendezvous; a model on the CPU
    with the card asked for is refused too."""
    from whisper_vits_svc_tpu_torch.infer import stream_extract as se
    from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
    from whisper_vits_svc_tpu_torch.models import crepe, hubert, whisper
    from whisper_vits_svc_tpu_torch.parallel import ddp
    from whisper_vits_svc_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = _tiny_hp()
    model = pipeline.build_infer_model(hp, device="cpu")
    spk = np.zeros(4, np.float32)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingSvc(model, spk, hp, block_frames=4, context_frames=2, device=device)
    stream = StreamingSvc(model, spk, hp, block_frames=4, context_frames=2, device="cpu")
    z = np.zeros((3, 4), np.float32)
    assert stream.push(z, z, np.full(3, 200.0, np.float32)).shape == (24,)

    w = whisper.WhisperEncoder(n_state=8, n_head=2, n_layer=1)
    h = hubert.HubertSoft(n_layers=1)
    c = crepe.Crepe("tiny")
    for make in (lambda d: se.StreamingWhisper(w, device=d),
                 lambda d: se.StreamingHubert(h, 16000, device=d),
                 lambda d: se.StreamingCrepe(c, device=d),
                 lambda d: se.StreamingExtractor(w, h, c, device=d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make("cuda")
        make("cpu")
    probs = np.full((3, crepe.PITCH_BINS), 1.0 / crepe.PITCH_BINS, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        crepe.viterbi_decode(probs)
    assert crepe.viterbi_decode(probs, device="cpu").shape == (3,)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ddp.initialize_distributed("localhost:1", 2, 0)
    assert not ddp.is_initialized()
    assert ddp.initialize_distributed(None, device="cpu") == torch.device("cpu")
    hp["dist"] = dict(coordinator_address="localhost:1", num_processes=2, process_id=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(hp, "t")
    assert not ddp.is_initialized()


def test_misc_entry_points_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """The cli.misc entry points that run a model (shift, batch, post) and
    the new engines refuse to start without CUDA before they read a file;
    merge, eva and train-retrieval run no model and take no device."""
    from whisper_vits_svc_tpu_torch.cli import misc
    from whisper_vits_svc_tpu_torch.models import f0_alt, salience, silero_vad, swipe

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_args = ["--config", "c.yaml", "--model", "m.pth", "--spk", "s.npy"]
    for argv in (["shift", *model_args, "--wave", "w.wav"],
                 ["batch", *model_args, "--folder", "songs"],
                 ["post", "--ref", "r.wav", "--svc", "s.wav"],
                 ["post", "--ref", "r.wav", "--svc", "s.wav", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            misc.main(argv)
    assert os.listdir(tmp_path) == []
    x = np.zeros(4000, np.float32)
    for call in (lambda: f0_alt.yin(x), lambda: f0_alt.pyin(x), lambda: swipe.swipe(x),
                 lambda: salience.compute_f0_sing_salience(x),
                 lambda: silero_vad.build_silero_vad(silero_vad.SileroVAD().state_dict())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for name in ("merge", "eva", "train-retrieval"):
        assert "--device" not in _options(misc.ENTRY_POINTS[name])


def _options(entry) -> str:
    """The --help text of a cli.misc entry point."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        entry(["--help"])
    return out.getvalue()


def test_prep_export_webui_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """cli.preprocessing, cli.export and cli.webui refuse to start without
    CUDA before they read or write a file; so do the preprocessing driver,
    the spectrogram buckets and the serving functions."""
    from whisper_vits_svc_tpu_torch.cli import export, preprocessing, webui
    from whisper_vits_svc_tpu_torch.data import preprocess
    from whisper_vits_svc_tpu_torch.infer import serving

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((preprocessing.main, []), (preprocessing.main, ["--device", "cuda"]),
                       (export.main, ["--checkpoint", "c.pth"]),
                       (webui.main, ["--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert os.listdir(tmp_path) == []
    hp = _tiny_hp()
    for call in (lambda: preprocess.preprocess("raw"),
                 lambda: preprocess.compute_spec_bucketed(np.zeros(4000, np.float32),
                                                          1024, 320, 1024),
                 lambda: serving.build_synthesis_fn({}, hp),
                 lambda: serving.export_synthesis({}, hp, "a.pt2")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert os.listdir(tmp_path) == []
