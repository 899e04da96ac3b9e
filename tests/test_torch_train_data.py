"""The data side of the port's training loop against the JAX package's, on the
same synthetic filelists: items, crops and every batch of two epochs equal to
the bit; the native loader against its numpy route and JAX's; the prefetch
thread; the linear spectrogram of validation's panels."""

import hashlib
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_train_loop import _make_data
from whisper_vits_svc_tpu.data import dataset as jdataset
from whisper_vits_svc_tpu.data import native_loader as jnl
from whisper_vits_svc_tpu.ops.stft import linear_spectrogram as j_linear_spectrogram
from whisper_vits_svc_tpu.utils.audio_io import load_wav as j_load_wav
from whisper_vits_svc_tpu.utils.audio_io import save_wav as j_save_wav
from whisper_vits_svc_tpu.utils.config import load_config as j_load_config
from whisper_vits_svc_tpu.utils.testing import micro_hp, tiny_hp
from whisper_vits_svc_tpu_torch.data import dataset
from whisper_vits_svc_tpu_torch.data import native_loader as nl
from whisper_vits_svc_tpu_torch.data.prefetch import prefetch
from whisper_vits_svc_tpu_torch.ops.stft import linear_spectrogram
from whisper_vits_svc_tpu_torch.utils import audio_io
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"tiny": tiny_hp, "micro": micro_hp}


def _assert_same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _both(fl, hp):
    return (dataset.SvcDataset(str(fl), config_from_dict(hp).data),
            jdataset.SvcDataset(str(fl), hp.data))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_items_and_crops_equal_jax(tmp_path, config):
    """The 1-4 s filter, the usable lengths and each item's random crop (the
    x2 frame repeat and the spec/audio trims included) equal JAX's."""
    _, fl, hp = _make_data(tmp_path, np.random.default_rng(1234), CONFIGS[config]())
    ds, jds = _both(fl, hp)
    assert len(ds) == len(jds) > 0
    assert ds.lengths == jds.lengths
    assert (ds.min_frames, ds.max_frames) == (jds.min_frames, jds.max_frames)
    for i in range(len(ds)):
        _assert_same(ds.get(i, np.random.default_rng(i)), jds.get(i, np.random.default_rng(i)))
        _assert_same(ds.get(i), jds.get(i))


@pytest.mark.parametrize("epoch", [1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_epoch_batches_equal_jax(tmp_path, config, epoch):
    """Every batch of an epoch (order, crops, padding, lengths), with the
    config's boundaries and with the JAX test's finer ones, equal JAX's to
    the bit, key by key."""
    _, fl, hp = _make_data(tmp_path, np.random.default_rng(1234), CONFIGS[config]())
    ds, jds = _both(fl, hp)
    seg = hp.data.segment_size // hp.data.hop_length
    assert dataset.boundaries_for(config_from_dict(hp).data) == jdataset.boundaries_for(hp.data)
    for boundaries in (jdataset.boundaries_for(hp.data), tuple(seg * k for k in (4, 8, 12, 16, 20))):
        batcher = dataset.BucketBatcher(ds, 2, boundaries=boundaries, seed=hp.train.seed)
        jbatcher = jdataset.BucketBatcher(jds, 2, boundaries=boundaries, seed=hp.train.seed)
        assert batcher.buckets == jbatcher.buckets
        got, ref = list(batcher.epoch_batches(epoch)), list(jbatcher.epoch_batches(epoch))
        assert len(got) == len(ref) == batcher.batches_per_epoch() == jbatcher.batches_per_epoch()
        for b, jb in zip(got, ref):
            _assert_same(b, jb)
            for i, t in enumerate(b["ppg_l"]):  # the pad tails are zero
                assert not b["ppg"][i, t:].any() and not b["audio"][i, t * hp.data.hop_length:].any()


def test_long_utterance_cropped_into_top_bucket(tmp_path, rng):
    """At base.yaml's hop and segment, a 6 s utterance is cropped to the 4 s
    cap (400 frames) and lands in the top (300, 450] bucket, as in JAX."""
    hp = j_load_config(os.path.join(REPO, "configs", "base.yaml"))
    hop, sr = hp.data.hop_length, hp.data.sampling_rate
    frames = 600
    j_save_wav(str(tmp_path / "a.wav"), (rng.standard_normal(frames * hop) * 0.1).astype(np.float32), sr)
    np.save(tmp_path / "a.spec.npy", np.abs(rng.standard_normal(
        (frames, hp.data.filter_length // 2 + 1))).astype(np.float32))
    np.save(tmp_path / "a.pit.npy", rng.uniform(100, 400, frames + 1).astype(np.float32))
    half = frames // 2 + 2
    np.save(tmp_path / "a.vec.npy", rng.standard_normal((half, hp.vits.vec_dim)).astype(np.float32))
    np.save(tmp_path / "a.ppg.npy", rng.standard_normal((half, hp.vits.ppg_dim)).astype(np.float32))
    np.save(tmp_path / "a.spk.npy", rng.standard_normal(hp.vits.spk_dim).astype(np.float32))
    fl = tmp_path / "train.txt"
    fl.write_text("|".join(str(tmp_path / f"a.{e}") for e in
                           ("wav", "spec.npy", "pit.npy", "vec.npy", "ppg.npy", "spk.npy")))
    ds, jds = _both(fl, hp)
    assert len(ds) == 1 and ds.items[0].frames == 400
    batcher = dataset.BucketBatcher(ds, 1, boundaries=dataset.boundaries_for(ds.hp))
    assert [len(b) for b in batcher.buckets] == [0, 1]
    (b,) = list(batcher.epoch_batches(0))
    assert b["ppg"].shape == (1, 400, hp.vits.ppg_dim) and b["audio"].shape == (1, 400 * hop, 1)
    assert int(b["ppg_l"][0]) == 400 and np.abs(b["audio"][0, -hop:]).max() > 0
    jbatcher = jdataset.BucketBatcher(jds, 1, boundaries=jdataset.boundaries_for(hp.data))
    _assert_same(b, next(iter(jbatcher.epoch_batches(0))))


@pytest.mark.parametrize("layout", ["bins_first_npy", "pt"])
def test_reference_spec_layouts(tmp_path, layout):
    """A reference [bins, T] spec, as .npy or as a torch .pt, is read in the
    [T, bins] layout, as the JAX package reads it."""
    _, fl, hp = _make_data(tmp_path, np.random.default_rng(5), tiny_hp())
    rows = []
    for line in fl.read_text().splitlines():
        cols = line.split("|")
        spec = np.load(cols[1])
        if layout == "pt":
            cols[1] = cols[1].replace(".spec.npy", ".spec.pt")
            torch.save(torch.from_numpy(spec.T.copy()), cols[1])
        else:
            np.save(cols[1], spec.T.copy())
        rows.append("|".join(cols))
    fl.write_text("\n".join(rows))
    ds, jds = _both(fl, hp)
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        ex = ds.get(i, np.random.default_rng(i))
        assert ex["spec"].shape[1] == hp.data.filter_length // 2 + 1
        _assert_same(ex, jds.get(i, np.random.default_rng(i)))


def _numpy_route(monkeypatch):
    monkeypatch.setattr(nl, "get_lib", lambda: None)


def _need_native():
    if not nl.available():
        pytest.skip("no C++ compiler for the native loader")


def test_native_loader_equals_numpy_route_and_jax(tmp_path, rng, monkeypatch):
    """Wav and npy reads through the port's native loader equal scipy/numpy
    and the JAX package's loader; non-float32 .npy files are refused; a
    batch read reports a missing file as None."""
    _need_native()
    wav = str(tmp_path / "a.wav")
    audio_io.save_wav(wav, (rng.standard_normal(12345) * 0.3).astype(np.float32), 32000)
    native, sr = nl.load_wav_native(wav)
    ref, sr_ref = audio_io.load_wav(wav)
    assert sr == sr_ref == 32000
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(ref, j_load_wav(wav)[0])
    if jnl.available():
        np.testing.assert_array_equal(native, jnl.load_wav_native(wav)[0])
    paths, arrays = [], []
    for i, shape in enumerate([(100,), (50, 16), (3, 4, 5)] + [(20 + k, 8) for k in range(8)]):
        paths.append(str(tmp_path / f"x{i}.npy"))
        arrays.append(rng.standard_normal(shape).astype(np.float32))
        np.save(paths[-1], arrays[-1])
    out = nl.load_npy_batch(paths + [str(tmp_path / "missing.npy")])
    assert out[-1] is None
    for a, got in zip(arrays, out):
        np.testing.assert_array_equal(got, a)
    np.save(tmp_path / "i64.npy", np.arange(10))
    np.save(tmp_path / "f64.npy", np.ones(10))
    assert nl.load_npy_batch([str(tmp_path / "i64.npy"), str(tmp_path / "f64.npy"),
                              paths[0]])[:2] == [None, None]
    assert nl.route() == "native"
    _numpy_route(monkeypatch)
    assert nl.route() == "numpy" and nl.load_npy_batch(paths[:2]) == [None, None]


def test_load_npy_native_equals_numpy_and_jax(tmp_path, rng, monkeypatch):
    """One .npy through load_npy_native: equal to numpy's read and the JAX
    package's; None for another dtype, a missing file, and without the
    library."""
    _need_native()
    path = str(tmp_path / "x.npy")
    a = rng.standard_normal((37, 6)).astype(np.float32)
    np.save(path, a)
    np.testing.assert_array_equal(nl.load_npy_native(path), a)
    if jnl.available():
        np.testing.assert_array_equal(nl.load_npy_native(path), jnl.load_npy_native(path))
    np.save(tmp_path / "f64.npy", np.ones(10))
    assert nl.load_npy_native(str(tmp_path / "f64.npy")) is None
    assert nl.load_npy_native(str(tmp_path / "missing.npy")) is None
    _numpy_route(monkeypatch)
    assert nl.load_npy_native(path) is None


def test_dataset_native_route_equals_numpy_route(tmp_path, monkeypatch):
    _need_native()
    _, fl, hp = _make_data(tmp_path, np.random.default_rng(9), tiny_hp())
    ds = dataset.SvcDataset(str(fl), config_from_dict(hp).data)
    native = [ds.get(i, np.random.default_rng(i)) for i in range(len(ds))]
    _numpy_route(monkeypatch)
    for i, ex in enumerate(native):
        _assert_same(ex, ds.get(i, np.random.default_rng(i)))


def test_native_build_stays_out_of_native_dir(tmp_path, monkeypatch):
    """A fresh build of the native loader lands in the build directory,
    named by the source hash, and leaves native/ (the committed
    libsvc_loader.so included) as it was."""
    native = os.path.join(REPO, "native")
    committed = os.path.join(native, "libsvc_loader.so")
    before = hashlib.sha256(open(committed, "rb").read()).hexdigest()
    listing = sorted(os.listdir(native))
    assert nl.BUILD_DIR.parts[-2:] == ("build", "native")
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_tried", False)
    lib = nl.get_lib()
    if shutil.which(os.environ.get("CXX", "g++")):
        assert lib is not None
        assert os.listdir(tmp_path / "build" / "native") == [nl.lib_path().name]
        assert nl.lib_path().name.startswith("libsvc_loader-")
    assert hashlib.sha256(open(committed, "rb").read()).hexdigest() == before
    assert sorted(os.listdir(native)) == listing


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in prefetch(failing(), depth=1):
            got.append(item)
    assert got == [1, 2]


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    """A consumer that leaves early, by a break or an exception, ends the
    producer after its current item: no thread is left blocked on the full
    queue holding batches."""
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield np.zeros(1000)

    def alive():
        return [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]

    for _ in prefetch(source(), depth=2):
        break
    assert not alive() and len(produced) <= 5
    with pytest.raises(RuntimeError, match="consumer failed"):
        for _ in prefetch(source(), depth=2):
            raise RuntimeError("consumer failed")
    assert not alive()


@pytest.mark.parametrize("n_fft,hop,win", [(128, 32, 128), (1024, 320, 1024), (64, 8, 32)])
def test_linear_spectrogram_matches_jax(n_fft, hop, win):
    """Within 1e-5 relative to the largest magnitude (the smallest bins carry
    the two DFTs' summation-order rounding)."""
    y = (np.random.default_rng(n_fft).standard_normal((2, 40 * hop)) * 0.3).astype(np.float32)
    got = linear_spectrogram(torch.from_numpy(y), n_fft, hop, win).numpy()
    ref = np.asarray(j_linear_spectrogram(jnp.asarray(y), n_fft, hop, win))
    assert got.shape == ref.shape == (2, 40, n_fft // 2 + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
