"""The front end's reference (reference/extract.py) against the program at
micro widths on the CPU, on the seeded weights of weights_extract.py
loaded through the program's own loaders: whisper's log-mel and encoder
(the checkpoint's blocks cut by a quarter, float16 values), HuBERT-soft at
natural length and on the program's padded, masked row, CREPE's
probabilities, and the stream's pitch; the weight maker's BatchNorm and
weight-norm rules; and the reference importing nothing of the program."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import extract as rx
from benchmark.weights_extract import (crepe_state_dict, hubert_state_dict,
                                       reference_whisper_state, whisper_checkpoint)
from whisper_vits_svc_tpu_torch.infer import stream_extract as se
from whisper_vits_svc_tpu_torch.models import crepe as pcrepe
from whisper_vits_svc_tpu_torch.models import hubert as phubert
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=4)
ROOT = Path(__file__).resolve().parent.parent.parent


def _audio(n, seed):
    t = np.arange(n) / 16000
    rng = np.random.default_rng(seed)
    tone = 0.3 * np.sin(2 * np.pi * 220 * (1 + 0.2 * t) * t) + 0.1 * np.sin(2 * np.pi * 440 * t)
    return (tone + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """{name: (program model, reference model, checkpoint)} from one seed."""
    d = tmp_path_factory.mktemp("ckpt")
    w = whisper_checkpoint(DIMS, 1, "cpu")
    h = hubert_state_dict(1, 2, "cpu")
    c = crepe_state_dict("tiny", 3, "cpu")
    for name, payload in (("w", w), ("h", h), ("c", c)):
        torch.save(payload, d / f"{name}.pt")
    ref_w = rx.whisper_encoder(DIMS).eval()
    ref_w.load_state_dict(reference_whisper_state(w))
    ref_h = rx.HubertSoft(1).eval()
    ref_h.load_state_dict(h)
    ref_c = rx.Crepe("tiny").eval()
    ref_c.load_state_dict(c)
    return dict(whisper=(pwhisper.load_whisper_encoder(str(d / "w.pt"), device="cpu"), ref_w, w),
                hubert=(phubert.load_hubert_soft(str(d / "h.pt"), device="cpu"), ref_h, h),
                crepe=(pcrepe.load_crepe(str(d / "c.pt"), device="cpu"), ref_c, c))


@pytest.mark.parametrize("n", [16000, 51200])
def test_log_mel(n):
    """Within 1e-4: the program's DFT is a matmul, the reference's an FFT,
    and their power differs by ~1e-7 of a frame's peak, which log10 makes
    ~3e-5 in a bin 30-40 dB under it."""
    a = _audio(n, 1)
    got = pwhisper.log_mel_spectrogram(torch.from_numpy(a)[None])
    want = rx.log_mel(torch.from_numpy(a)[None]).transpose(1, 2)
    assert got.shape == want.shape == (1, n // 160, 80)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_whisper_checkpoint_cut_and_float16(loaded):
    prog, ref, ckpt = loaded["whisper"]
    blocks = {k.split(".")[2] for k in ckpt["model_state_dict"] if ".blocks." in k}
    assert len(blocks) == 4 and len(prog.blocks) == len(ref.blocks) == 3
    assert {v.dtype for v in ckpt["model_state_dict"].values()} == {torch.float16}
    for k, v in ref.state_dict().items():
        assert torch.equal(prog.state_dict()[k], v), k


@pytest.mark.parametrize("n", [16000, 80000, rx.WINDOW_SAMPLES])
def test_whisper_ppg(loaded, n):
    """The program's window at its natural length against the reference; a
    whole 15 s window also through the program's zero-padded row."""
    prog, ref, _ = loaded["whisper"]
    a = _audio(n, 2)
    with torch.inference_mode():
        want = rx.ppg(ref, torch.from_numpy(a)[None])[0].numpy()
    got = pwhisper.ppg_window_batch(prog, a[None], np.array([n]))[0]
    assert got.shape == want.shape == (n // 320, 64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [16000, 48000])
def test_hubert_units(loaded, n):
    """At natural length and through the program's zero-padded, masked row
    of the stream's 3 s window."""
    prog, ref, _ = loaded["hubert"]
    a = _audio(n, 3)
    with torch.inference_mode():
        want = ref.units(torch.from_numpy(a)[None])[0].numpy()
    row = np.zeros((1, 48000), np.float32)
    row[0, :n] = a
    for windows in (a[None], row):
        got = phubert.vec_window_batch(prog, windows, np.array([n]))[0][: len(want)]
        assert len(want) == phubert.hubert_num_frames(n)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_crepe_probabilities(loaded):
    prog, ref, _ = loaded["crepe"]
    a = _audio(8000, 4)
    frames = rx.crepe_frames(torch.from_numpy(a), range(20))
    with torch.inference_mode():
        want = rx.crepe_probabilities(ref, frames, block=7).numpy()
    got = pcrepe.crepe_probabilities(prog, frames.numpy(), batch_size=64)
    assert got.shape == want.shape == (20, 360)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_crepe_frames_are_the_program_framing():
    a = _audio(6400, 5)
    want = pcrepe.frame_audio(a, 320)[:15]  # zero-padded 512 each side
    np.testing.assert_array_equal(rx.crepe_frames(torch.from_numpy(a), range(15)).numpy(), want)


def test_stream_pitch_matches_the_program(loaded):
    """The program's StreamingExtractor over 1.2 s in 0.2 s pushes against
    the reference's fixed-lag decode of the reference's probabilities on
    the stream's frames: the same 100 fps pitch within 1 cent, push by
    push."""
    a = _audio(19200, 6)
    ex = se.StreamingExtractor(loaded["whisper"][0], loaded["hubert"][0], loaded["crepe"][0],
                               block_samples=3200, hubert_context_seconds=0.4, device="cpu")
    ref, fl, stream = loaded["crepe"][1], rx.FixedLagPitch(), torch.from_numpy(a)
    for k in range(6):
        pushed = (k + 1) * 3200
        _, _, got = ex.push(a[k * 3200 : pushed])
        head = rx.crepe_head(pushed)
        assert head == ex.crepe.head
        with torch.inference_mode():
            probs = rx.crepe_probabilities(ref, rx.crepe_frames(stream, range(fl.head + 1,
                                                                              head + 1)))
        fl.advance(rx.observations(probs))
        want = fl.emit(pushed // 320 - 4)
        assert got.shape == want.shape
        np.testing.assert_array_less(np.abs(1200 * np.log2(got / want)), 1.0)


def _glide(n, seed):
    """A 150 -> 450 Hz log glide with a second harmonic and light noise."""
    f0 = np.geomspace(150.0, 450.0, n)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase)
            + 0.005 * rng.standard_normal(n)).astype(np.float32), f0


@pytest.fixture(scope="module")
def moving_crepe(loaded, tmp_path_factory):
    """(program, reference) CREPE "tiny" on the seeded convolutions with a
    classifier fitted so that the output follows the pitch: a ridge
    regression of Gaussian bumps at the true bin on the reference's
    features of a glide. The seeded classifier's decoded path sits on one
    bin, on which a fault in the decode cannot show."""
    c = dict(loaded["crepe"][2])
    ref = rx.Crepe("tiny").eval()
    ref.load_state_dict(c)
    a, f0 = _glide(40 * 3200, 21)
    frames = rx.crepe_frames(torch.from_numpy(a), range(len(a) // 320))
    feats = []
    hook = ref.classifier.register_forward_hook(lambda m, i, o: feats.append(i[0]))
    with torch.inference_mode():
        rx.crepe_probabilities(ref, frames)
    hook.remove()
    x = torch.cat(feats).double().numpy()
    cents = 1200 * np.log2(f0[np.arange(len(frames)) * 320] / 10.0) - rx.CENTS_OFFSET
    bins = cents / rx.CENTS_PER_BIN
    target = 12.0 * np.exp(-0.5 * ((np.arange(rx.PITCH_BINS)[None] - bins[:, None]) / 3.0) ** 2)
    xm, tm = x.mean(0), target.mean(0) - 6.0
    xc = x - xm
    w = np.linalg.solve(xc.T @ xc + 1e-3 * np.eye(x.shape[1]), xc.T @ (target - 6.0 - tm))
    c["classifier.weight"] = torch.from_numpy(w.T.astype(np.float32)).contiguous()
    c["classifier.bias"] = torch.from_numpy((tm - xm @ w).astype(np.float32))
    ref.load_state_dict(c)
    path = tmp_path_factory.mktemp("moving") / "c.pt"
    torch.save(c, path)
    return pcrepe.load_crepe(str(path), device="cpu"), ref


def test_stream_pitch_on_a_moving_path_and_the_decode_faults(loaded, moving_crepe):
    """On a CREPE whose decoded path follows a glide: the program's stream
    pitch equals the reference's fixed-lag decode with its trellis in the
    program's float32, push by push (`wave_live.flips` reads 0), and each
    fault the driver can plant there (`DECODE_FAULTS`: the pitch one frame
    late, the mean-5 filter left out) flips frames against it, as it would
    in a run whose path moves. (The run's reference keeps its
    trellis in float64, like the published librosa decode; on this glide
    that decides one near tie the other way, for a stretch of 11 frames.)"""
    from benchmark.drivers.wave_live import decode, flips, late

    prog, ref = moving_crepe
    a, _ = _glide(40 * 3200, 22)
    ex = se.StreamingExtractor(loaded["whisper"][0], loaded["hubert"][0], prog,
                               block_samples=3200, hubert_context_seconds=0.4, device="cpu")
    got = np.concatenate([ex.push(a[k * 3200 : (k + 1) * 3200])[2] for k in range(40)])
    pushed = [(k + 1) * 3200 for k in range(40)]
    heads, his = [rx.crepe_head(t) for t in pushed], [t // 320 - 4 for t in pushed]
    with torch.inference_mode():
        probs = rx.crepe_probabilities(ref, rx.crepe_frames(torch.from_numpy(a),
                                                            range(heads[-1] + 1)))
    obs = rx.observations(probs)
    pushes = decode(obs, heads, his, dtype=np.float32)
    want = np.concatenate(pushes)
    assert 1200 * np.log2(want[-20:].mean() / want[:20].mean()) > 600  # the path moves
    assert flips(got, want) == 0
    faulty = {"lag": flips(np.concatenate(late(pushes)), want),
              "filter": flips(np.concatenate(decode(obs, heads, his, filter_frames=1,
                                                    dtype=np.float32)), want)}
    assert all(n > 0 for n in faulty.values()), faulty


def test_weight_maker_norms():
    """BatchNorm variances in 1 +- 0.1 (never negative), means in +-0.1,
    gains in 1 +- 0.1; HuBERT's positional weight-norm gain is the norm of
    weight_v over dims 0 and 1 (the conv's dim 2), so the kernel starts
    equal to weight_v; whisper's LayerNorm gains in 1 +- 0.1."""
    c = crepe_state_dict("tiny", 7, "cpu")
    for i in range(1, 7):
        var, mean = c[f"conv{i}_BN.running_var"], c[f"conv{i}_BN.running_mean"]
        assert float(var.min()) >= 0.9 and float(var.max()) <= 1.1
        assert float(mean.abs().max()) <= 0.1
        assert float((c[f"conv{i}_BN.weight"] - 1).abs().max()) <= 0.1
    h = hubert_state_dict(1, 8, "cpu")
    g, v = h["positional_embedding.conv.weight_g"], h["positional_embedding.conv.weight_v"]
    assert g.shape == (1, 1, 128)
    torch.testing.assert_close(g, v.square().sum(dim=(0, 1), keepdim=True).sqrt())
    w = whisper_checkpoint(DIMS, 9, "cpu")["model_state_dict"]
    assert float((w["encoder.blocks.0.attn_ln.weight"].float() - 1).abs().max()) <= 0.1
    kernel = w["encoder.blocks.0.mlp.0.weight"].float()
    assert float(kernel.abs().max()) <= 64 ** -0.5 + 1e-3


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.extract; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    for name in ("whisper_vits_svc_tpu_torch", "whisper_vits_svc_tpu", "jax"):
        assert f"'{name}'" not in out
