"""The frozen reference against the program's CPU path at micro widths: the
state_dict layouts, a 2-chunk request's waveform, three pushes of a stream,
and two training steps' losses and updated parameters. The reference
imports nothing of the program or of JAX; these tests import both sides."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.compare import counted
from benchmark.reference.disc import Discriminator
from benchmark.reference.infer import convert_song, convert_stream
from benchmark.reference.step import TrainStep
from benchmark.reference.synth import SynthesizerInfer, SynthesizerTrn
from benchmark.tests.conftest import micro_model
from benchmark.traffic.features import f0_contour, train_pool
from benchmark.weights import make_state_dict, shapes_of
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

REFERENCE = Path(__file__).resolve().parent.parent / "reference"
ALLOWED_IMPORTS = {"__future__", "math", "functools", "numpy", "torch"}


@pytest.fixture(scope="module")
def mc():
    return micro_model()


def _features(mc, frames, seed):
    r = np.random.default_rng(seed)
    v = mc["vits"]
    return dict(spk=(r.standard_normal(v["spk_dim"]) / 3).astype(np.float32),
                ppg=(r.standard_normal((frames, v["ppg_dim"])) * 0.5).astype(np.float32),
                vec=(r.standard_normal((frames, v["vec_dim"])) * 0.5).astype(np.float32),
                pit=f0_contour(frames, 180.0, int(r.integers(0, 300))))


def _infer_pair(mc, seed=3):
    hp = config_from_dict(mc)
    sd = make_state_dict(shapes_of(lambda: SynthesizerInfer(mc)), seed, "cpu")
    prog = pipeline.build_infer_model(hp, device="cpu")
    prog.load_state_dict(sd)
    ref = SynthesizerInfer(mc).eval()
    ref.load_state_dict(sd)
    return hp, prog, ref


@pytest.mark.parametrize("pair", ["infer", "generator_trn", "discriminator"])
def test_state_dict_layouts_match(mc, pair):
    hp = config_from_dict(mc)
    if pair == "infer":
        prog, ref = pipeline.build_infer_model(hp, device="cpu"), SynthesizerInfer
    else:
        with torch.device("meta"):
            g, d = tstep.build_models(hp)
        prog, ref = (g, SynthesizerTrn) if pair == "generator_trn" else (d, Discriminator)
    want = {k: tuple(t.shape) for k, t in prog.state_dict().items()}
    got = {k: tuple(s) for k, s in shapes_of(lambda: ref(mc)).items()}
    assert got == want


def test_two_chunk_request_waveform(mc):
    hp, prog, ref = _infer_pair(mc)
    f = _features(mc, 37, 1)  # out_chunk 20, hop_frame 2: two chunks, the last padded
    want = pipeline.svc_infer(prog, DummyRetrieval(), f["spk"], f["pit"], f["ppg"], f["vec"], hp,
                              noise_scale=1.0, seed=11, out_chunk=20, hop_frame=2, device="cpu")
    got = convert_song(ref, f["spk"], f["pit"], f["ppg"], f["vec"], 11, "cpu", 20, 2, 1.0)
    assert got.shape == want.shape == (37 * 8,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_three_pushes(mc):
    hp, prog, ref = _infer_pair(mc, seed=4)
    f = _features(mc, 30, 2)
    svc = StreamingSvc(prog, f["spk"], hp, block_frames=10, context_frames=5, noise_scale=1.0,
                       seed=21, device="cpu")
    want = [svc.push(f["ppg"][i : i + 10], f["vec"][i : i + 10], f["pit"][i : i + 10])
            for i in (0, 10, 20)]
    got = convert_stream(ref, f["spk"], f["ppg"], f["vec"], f["pit"], 3, 21, "cpu", 10, 5, 1.0)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (80,)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_two_training_steps(mc):
    """Two calls at accum_step 2: D steps twice, G once; losses within 1e-5
    and every parameter within 1e-6 of its value after the two calls, but
    the leaves whose gradient is nought to rounding (an attention key's
    bias under the softmax), which AdamW moves by their noise alone."""
    hp = config_from_dict(mc)
    sd_g = make_state_dict(shapes_of(lambda: SynthesizerTrn(mc)), 5, "cpu")
    sd_d = make_state_dict(shapes_of(lambda: Discriminator(mc)), 6, "cpu")
    g_state, d_state = tstep.init_train_states(hp, device="cpu")
    g_state.model.load_state_dict(sd_g)
    d_state.model.load_state_dict(sd_d)
    step = tstep.make_train_step(hp, g_state, d_state)
    ref = TrainStep(mc, sd_g, sd_d, "cpu")
    pool = train_pool(mc, dict(utterances=8, min_frames=10, max_frames=30, bucket_frames=10,
                               batch=4), 9, "cpu")
    gen_p, gen_r = torch.Generator().manual_seed(13), torch.Generator().manual_seed(13)
    for i, batch in enumerate(pool[:2]):
        m = step(batch, gen_p)
        loss_g, loss_d, g_grads, _ = ref(batch, gen_r)
        assert float(m["loss_g"]) == pytest.approx(float(loss_g), rel=1e-5)
        assert float(m["loss_d"]) == pytest.approx(float(loss_d), rel=1e-5)
        if i == 0:
            names = [n for n, _ in ref.g.named_parameters()]
            leaves = counted({n: float(g.norm()) for n, g in zip(names, g_grads)})
    assert {n for n in names if n not in leaves} == {
        n for n in names if n.endswith("conv_k.bias")}
    for (name, p), (_, q) in zip(g_state.model.named_parameters(), ref.g.named_parameters()):
        if name in leaves:
            torch.testing.assert_close(p.detach(), q.detach(), atol=1e-6, rtol=0, msg=name)
    for (name, p), (_, q) in zip(d_state.model.named_parameters(), ref.d.named_parameters()):
        torch.testing.assert_close(p.detach(), q.detach(), atol=1e-6, rtol=0, msg=name)
    moved = sum(not torch.equal(p.detach(), sd_g[n]) for n, p in g_state.model.named_parameters())
    assert moved > 0.9 * len(sd_g)  # G stepped on the second call


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in ALLOWED_IMPORTS, (path.name, n)


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.step, benchmark.reference.infer; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REFERENCE.parent.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    for name in ("whisper_vits_svc_tpu_torch", "whisper_vits_svc_tpu", "jax"):
        assert f"'{name}'" not in out
