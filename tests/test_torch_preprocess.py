"""The port's preprocessing driver (whisper_vits_svc_tpu_torch/data/preprocess.py)
against the JAX package's, on the CPU at the JAX tests' tiny extractor widths
(tests/test_preprocess_staged.py:40-60) and its five waves: the staged driver
equals the port's serial loop (pitch bitwise, features 1e-4, specs 1e-5) and
reruns as all cache hits; the window stage's PPG and units equal JAX's
ppg_window_batch / vec_window_batch on the same bucketed rows (1e-4); the
host functions (the spectrogram buckets, the window walk, CDC and its int16
truncation, the pydub silence split, the filelists) equal JAX's: rows and
ranges exact, audio within 1e-5. Weights go JAX -> port through
`models/convert.py::from_jax_*`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_preprocess_staged import _make_raw
from whisper_vits_svc_tpu.data import preprocess as jprep
from whisper_vits_svc_tpu.models import hubert as jhubert
from whisper_vits_svc_tpu.models import whisper as jwhisper
from whisper_vits_svc_tpu.ops.stft import linear_spectrogram as j_linear_spectrogram
from whisper_vits_svc_tpu_torch.cli import preprocessing as cli
from whisper_vits_svc_tpu_torch.data import preprocess as prep
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models import crepe as pcrepe
from whisper_vits_svc_tpu_torch.models import hubert as phubert
from whisper_vits_svc_tpu_torch.models import speaker_encoder as pspk
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper
from whisper_vits_svc_tpu_torch.ops.stft import linear_spectrogram
from whisper_vits_svc_tpu_torch.utils.audio_io import load_wav

HUBERT_WINDOW_S = 2  # the 2.1 s wave crosses a HuBERT window
SUBS = [("pitch", 0.0), ("whisper", 1e-4), ("hubert", 1e-4), ("speaker", 1e-4),
        ("specs", 1e-5), ("singer", 1e-4)]


def _perturbed(tree, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def extractors():
    """The JAX tests' tiny extractor widths (whisper 64 x 1 layer, HuBERT 1
    layer, CREPE tiny, LSTM 2 x 32 -> 16). Whisper and HuBERT are
    JAX-initialised and perturbed, and carried to the port by from_jax_*
    (their window stage is held to JAX's below); CREPE and the LSTM, held to
    JAX in tests/test_torch_extractors.py, are seeded port modules."""
    def init(model, seed, x):  # jitted: flax's eager init dispatches op by op
        return jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"]

    wm = jwhisper.WhisperEncoder(n_mels=80, n_ctx=1500, n_state=64, n_head=4, n_layer=1)
    wp = _perturbed(init(wm, 0, jnp.zeros((1, 16, 80))), 0, 0.02)
    hm = jhubert.HubertSoft(n_layers=1)
    hpar = _perturbed(init(hm, 1, jnp.zeros((1, 4000))), 1, 0.02)

    ex = prep.Extractors()
    ex.whisper = pwhisper.WhisperEncoder(n_state=64, n_head=4, n_layer=1).eval()
    ex.whisper.load_state_dict(convert.from_jax_whisper(wp), strict=True)
    ex.hubert = phubert.HubertSoft(n_layers=1).eval()
    ex.hubert.load_state_dict(convert.from_jax_hubert(hpar), strict=True)
    torch.manual_seed(2)
    ex.crepe = pcrepe.Crepe("tiny").eval()
    ex.speaker = pspk.LSTMSpeakerEncoder(input_dim=80, proj_dim=16, lstm_dim=32,
                                         num_layers=2).eval()
    return ex, dict(whisper=(wm, wp), hubert=(hm, hpar))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, extractors):
    """The five waves through the port's serial loop and its staged driver
    (4 windows a batch), then the staged driver once more."""
    ex, _ = extractors
    tmp = tmp_path_factory.mktemp("prep")
    raw = str(tmp / "dataset_raw")
    os.makedirs(raw)
    n_items = _make_raw(raw, np.random.default_rng(1234))
    kw = dict(valid_count=1, progress=False, hubert_window_seconds=HUBERT_WINDOW_S,
              device="cpu")
    serial = prep.preprocess(raw, str(tmp / "svc_serial"), str(tmp / "files_serial"), None,
                             ex, serial=True, **kw)
    staged = prep.preprocess(raw, str(tmp / "svc_staged"), str(tmp / "files_staged"), None,
                             ex, batch_windows=4, **kw)
    rerun = prep.preprocess(raw, str(tmp / "svc_staged"), str(tmp / "files_staged"), None,
                            ex, batch_windows=4, **kw)
    return tmp, n_items, serial, staged, rerun


def _npy_files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs if f.endswith(".npy")]
    return sorted(out)


def test_staged_driver_matches_serial(runs):
    tmp, n_items, serial, staged, rerun = runs
    assert serial["items"] == staged["items"] == n_items == 5
    assert serial["rows"] == staged["rows"] == rerun["rows"] == n_items
    for sub, tol in SUBS:
        files = _npy_files(tmp / "svc_serial" / sub)
        assert files and files == _npy_files(tmp / "svc_staged" / sub), sub
        for f in files:
            a = np.load(tmp / "svc_serial" / sub / f)
            b = np.load(tmp / "svc_staged" / sub / f)
            assert a.shape == b.shape, (sub, f)
            if tol == 0.0:
                np.testing.assert_array_equal(a, b, err_msg=f"{sub}/{f}")
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{sub}/{f}")
    # the same waves at 16 and 32 kHz, the same filelists
    for sub in ("waves-16k", "waves-32k"):
        for spk in os.listdir(tmp / "svc_serial" / sub):
            for f in os.listdir(tmp / "svc_serial" / sub / spk):
                assert (tmp / "svc_serial" / sub / spk / f).read_bytes() == \
                    (tmp / "svc_staged" / sub / spk / f).read_bytes()
    for name in ("train.txt", "valid.txt"):
        a = (tmp / "files_serial" / name).read_text().replace("svc_serial", "svc_staged")
        assert a == (tmp / "files_staged" / name).read_text()
    # the rerun finds every cache and recomputes nothing
    assert staged["skipped"] == dict.fromkeys(
        ("resample", "pitch", "whisper", "hubert", "speaker", "specs"), 0)
    assert rerun["skipped"] == dict.fromkeys(staged["skipped"], n_items)


@pytest.mark.parametrize("batch_frames", [37, 1024])
def test_crepe_stage_packs_frames_across_utterances(runs, extractors, tmp_path, batch_frames):
    """The staged CREPE stage at 37 frames a batch (every utterance spans
    batches and most batches hold two) and at 1024 (one batch, its tail
    zero-padded) writes the serial loop's pitch to the bit."""
    tmp, n_items = runs[0], runs[1]
    ex, _ = extractors
    pending, serial = [], []
    wav_root = tmp / "svc_serial" / "waves-16k"
    for spk in sorted(os.listdir(wav_root)):
        for f in sorted(os.listdir(wav_root / spk)):
            name = f[: -len(".wav")]
            pending.append((str(wav_root / spk / f), str(tmp_path / f"{spk}-{name}.pit.npy")))
            serial.append(tmp / "svc_serial" / "pitch" / spk / f"{name}.pit.npy")
    logged = []
    prep._run_crepe_stage(pending, ex.crepe, 1234, logged.append, batch_frames=batch_frames)
    assert logged == [f"pitch: {n_items} utterances"]
    for (_, out), want in zip(pending, serial):
        np.testing.assert_array_equal(np.load(out), np.load(want), err_msg=out)


def test_serial_rerun_counts_every_stage_skipped(runs, extractors):
    tmp, n_items, *_ = runs
    ex, _ = extractors
    stats = prep.preprocess(str(tmp / "dataset_raw"), str(tmp / "svc_serial"),
                            str(tmp / "files_serial"), None, ex, serial=True, valid_count=1,
                            progress=False, hubert_window_seconds=HUBERT_WINDOW_S,
                            device="cpu")
    assert stats["skipped"] == dict.fromkeys(
        ("resample", "pitch", "whisper", "hubert", "speaker", "specs"), n_items)


@pytest.mark.parametrize("kind", ["whisper", "hubert"])
def test_window_stage_matches_jax_window_batch(runs, extractors, kind):
    """Each utterance's staged features against JAX's window-batch function
    on the same windows, each zero-padded to its size bucket."""
    tmp = runs[0]
    _, jax_models = extractors
    jm, jp = jax_models[kind]
    if kind == "whisper":
        window, sub, suffix = pwhisper.WINDOW_SAMPLES, "whisper", ".ppg.npy"
        run = lambda rows, lens: jwhisper.ppg_window_batch(jm, jp, rows, lens, rng=None)
        frames_of = lambda ln: ln // pwhisper.PPG_HOP
    else:
        window, sub, suffix = HUBERT_WINDOW_S * 16000, "hubert", ".vec.npy"
        run = lambda rows, lens: jhubert.vec_window_batch(jm, jp, rows, lens)
        frames_of = jhubert.hubert_num_frames
    buckets = jprep._window_buckets(window)
    n_windows = 0
    wav_root = tmp / "svc_staged" / "waves-16k"
    for spk in sorted(os.listdir(wav_root)):
        for f in sorted(os.listdir(wav_root / spk)):
            audio, _ = load_wav(str(wav_root / spk / f))
            parts = []
            for row, ln in jprep._cut_windows(audio, window):
                b = next(bk for bk in buckets if ln <= bk)
                out = np.asarray(run(row[None, :b], np.array([ln])))
                parts.append(out[0, : frames_of(ln)])
                n_windows += 1
            got = np.load(tmp / "svc_staged" / sub / spk / (f[:-4] + suffix))
            want = np.concatenate(parts)
            assert got.shape == want.shape, (spk, f)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"{spk}/{f}")
    assert n_windows > 5 if kind == "hubert" else n_windows == 5


def test_spec_bucketed_matches_jax_and_linear_spectrogram():
    rng = np.random.default_rng(1234)
    for n in [3210, 32000, 45001]:
        a = (rng.standard_normal(n) * 0.3).astype(np.float32)
        got = prep.compute_spec_bucketed(a, 1024, 320, 1024, device="cpu")
        want = linear_spectrogram(torch.from_numpy(a)[None], 1024, 320, 1024)[0].numpy()
        ref = np.asarray(j_linear_spectrogram(jnp.asarray(a)[None], 1024, 320, 1024))[0]
        assert got.shape == want.shape == ref.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jprep.compute_spec_bucketed(a, 1024, 320, 1024),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,window", [(0, 320), (1, 320), (3200, 320), (3201, 320),
                                      (70000, 32000)])
def test_window_walk_and_buckets_match_jax(n, window):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got, want = prep._cut_windows(audio, window), jprep._cut_windows(audio, window)
    assert [ln for _, ln in got] == [ln for _, ln in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for w in (window, 240000, 320000, 30000):
        assert prep._window_buckets(w) == jprep._window_buckets(w)


def test_cut_direct_content_matches_jax():
    sr = 16000
    t = np.arange(sr + 123, dtype=np.float32) / sr
    y = (0.3 + 0.2 * np.sin(2 * np.pi * 20 * t) + 0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    got = prep.cut_direct_content(y)
    want = np.asarray(jprep.cut_direct_content(y))
    assert got.dtype == np.float32 and got.shape == want.shape == y.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(float(np.mean(got))) < 1e-3
    # truncation toward zero, clamped at both ends
    x = np.array([-1.5, -1.0, -0.5 / 32768, -3.7 / 32768, 0.0, 3.7 / 32768, 0.99999, 2.0],
                 np.float32)
    np.testing.assert_array_equal(prep._quantize_int16_trunc(x), jprep._quantize_int16_trunc(x))
    np.testing.assert_array_equal(prep._quantize_int16_trunc(x),
                                  [-32768, -32768, 0, -3, 0, 3, 32767, 32767])


def _gappy(sr, seed):
    """Tones and quiet gaps of 0.05-1.2 s, so some gaps are below 200 ms."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(6):
        n = int(sr * rng.uniform(0.3, 0.9))
        parts.append((0.5 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(n) / sr)))
        parts.append(1e-4 * rng.standard_normal(int(sr * rng.uniform(0.05, 1.2))))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("sr,seed", [(16000, 0), (32000, 1), (44100, 2)])
def test_silence_split_matches_jax(sr, seed):
    y = _gappy(sr, seed)
    assert prep.detect_silence_ms(y, sr) == jprep.detect_silence_ms(y, sr)
    assert len(prep.detect_silence_ms(y, sr)) >= 2
    got, want = prep.split_on_silence(y, sr), jprep.split_on_silence(y, sr)
    assert [len(c) for c in got] == [len(c) for c in want]
    np.testing.assert_array_equal(prep.trim_silence_concat(y, sr),
                                  jprep.trim_silence_concat(y, sr))
    quiet = np.zeros(sr // 10, np.float32)  # shorter than min_silence_len
    assert prep.detect_silence_ms(quiet, sr) == jprep.detect_silence_ms(quiet, sr) == []


def test_cdc_and_trim_directories(tmp_path):
    """cdc_directory and trim_directory write, per speaker, the int16 of the
    port's float functions on each wave."""
    from whisper_vits_svc_tpu_torch.utils.audio_io import save_wav

    for spk in ("a", "b"):
        os.makedirs(tmp_path / "in" / spk)
        save_wav(str(tmp_path / "in" / spk / "x.wav"), _gappy(16000, ord(spk)) + 0.1, 16000)
    (tmp_path / "in" / "notes.txt").write_text("not a speaker")
    assert prep.cdc_directory(str(tmp_path / "in"), str(tmp_path / "cdc"), progress=False) == 2
    assert prep.trim_directory(str(tmp_path / "in"), str(tmp_path / "trim"),
                               progress=False) == 2
    from scipy.io import wavfile

    for spk in ("a", "b"):
        audio, sr = load_wav(str(tmp_path / "in" / spk / "x.wav"))
        _, cdc = wavfile.read(tmp_path / "cdc" / spk / "x.wav")
        np.testing.assert_array_equal(
            cdc, prep._quantize_int16_trunc(prep.cut_direct_content(audio)))
        _, trim = wavfile.read(tmp_path / "trim" / spk / "x.wav")
        np.testing.assert_array_equal(
            trim, prep._quantize_int16_trunc(prep.trim_silence_concat(audio, sr)))
        assert len(trim) < len(audio)


def test_build_filelists_matches_jax(runs):
    tmp = runs[0]
    out = str(tmp / "svc_staged")
    rows = prep.build_filelists(out, str(tmp / "fl_port"), valid_count=2, seed=7)
    jrows = jprep.build_filelists(out, str(tmp / "fl_jax"), valid_count=2, seed=7)
    assert rows == jrows and len(rows) == 5
    for name in ("train.txt", "valid.txt"):
        assert (tmp / "fl_port" / name).read_bytes() == (tmp / "fl_jax" / name).read_bytes()
    # a missing cache drops its row, in both packages
    spec = next((tmp / "svc_staged" / "specs" / "spk_a").iterdir())
    spec.rename(str(spec) + ".bak")
    try:
        assert prep.build_filelists(out, str(tmp / "fl_port"), 2, 7) == \
            jprep.build_filelists(out, str(tmp / "fl_jax"), 2, 7)
        assert len(prep.build_filelists(out, str(tmp / "fl_port"), 2, 7)) == 4
    finally:
        os.rename(str(spec) + ".bak", spec)


def _write_reference_checkpoints(root, ex) -> dict:
    """The tiny extractors in the reference checkpoint layouts."""
    w = ex.whisper
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
                n_audio_layer=1)  # the loader keeps 1 - 1 // 4 = 1 block
    wsd = {f"encoder.{k}": v for k, v in w.state_dict().items()}
    payloads = {"whisper": {"dims": dims, "model_state_dict": wsd},
                "hubert": ex.hubert.state_dict(), "crepe": ex.crepe.state_dict(),
                "speaker": {"model": ex.speaker.state_dict()}}
    paths = {}
    for name, payload in payloads.items():
        paths[name] = str(root / f"{name}.pt")
        torch.save(payload, paths[name])
    return paths


def test_preprocessing_cli_on_cpu(tmp_path, extractors, monkeypatch, capsys):
    """The CLI with --device cpu from reference-layout checkpoints: every
    stage runs, the filelists hold every item, and the dry run passes; a
    missing checkpoint skips its stage with a line that says so."""
    import json

    from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG

    from whisper_vits_svc_tpu_torch.utils.audio_io import save_wav

    ex, _ = extractors
    monkeypatch.chdir(tmp_path)
    n_items = 0
    for spk, secs in (("s0", 1.3), ("s1", 1.6)):  # at least one 1 s item in train.txt
        os.makedirs(f"dataset_raw/{spk}")
        save_wav(f"dataset_raw/{spk}/u0.wav", _gappy(44100, n_items)[: int(44100 * secs)],
                 44100)
        n_items += 1
    paths = _write_reference_checkpoints(tmp_path, ex)
    cfg = dict(BASE_MODEL_CONFIG)
    cfg["train"] = dict(cfg["train"], batch_size=2)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    argv = ["-c", "c.json", "--whisper-ckpt", paths["whisper"], "--hubert-ckpt",
            paths["hubert"], "--crepe-ckpt", paths["crepe"], "--speaker-ckpt",
            paths["speaker"], "--batch-windows", "2", "--device", "cpu"]
    stats = cli.main(argv)
    out = capsys.readouterr().out
    assert stats["items"] == stats["rows"] == n_items
    assert "dataset dry-run ok" in out and "[skip]" not in out
    for sub in ("pitch", "whisper", "hubert", "speaker", "specs"):
        assert len(_npy_files(tmp_path / "data_svc" / sub)) == n_items, sub
    ppg = np.load(tmp_path / "data_svc" / "whisper" / "s1" / "u0.ppg.npy")
    assert ppg.shape == (int(1.6 * 16000) // 320, 64)
    # rerun with one checkpoint gone: its stage is skipped and says so
    stats = cli.main(argv + ["--speaker-ckpt", "missing.pt"])
    assert "[skip] speaker checkpoint missing: missing.pt" in capsys.readouterr().out
    assert stats["skipped"]["specs"] == n_items and "speaker" not in stats["skipped"]


def test_spectrogram_constants_from_inference_mode_serve_autograd():
    """A DFT basis first built under inference_mode (the driver's spec stage)
    still serves a training loss's autograd in the same process (the WebUI's
    one-key preprocess then train): the cached constants are built outside
    inference mode."""
    from whisper_vits_svc_tpu_torch.ops.stft import stft_magnitude

    n_fft, hop = 384, 96  # a basis no other test of this file builds first
    with torch.inference_mode():
        prep._spec_program(torch.zeros(1, 4 * n_fft), n_fft, hop, n_fft)
    x = torch.randn(1, 4 * n_fft, requires_grad=True, generator=torch.Generator().manual_seed(0))
    stft_magnitude(x, n_fft, hop, n_fft, mag_eps=1e-6).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
