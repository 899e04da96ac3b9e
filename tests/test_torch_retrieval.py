"""The port's retrieval blend and banks against the JAX package's: the top-k
blend, the order of equal distances, the banks JAX's build_index writes,
create_retrieval, and the kmeans compression."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import retrieval as jretrieval
from whisper_vits_svc_tpu_torch.infer import retrieval as pretrieval


def _bank(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("k,ratio", [(1, 0.5), (3, 0.5), (8, 0.3), (3, 1.0)])
def test_blend_matches_jax(k, ratio):
    """Queries near bank vectors (so that a few neighbours dominate) and far
    ones. float32 distances from the |q|^2 + |b|^2 - 2 q.b form, summed in
    other orders: 1e-4 on features of order 1."""
    bank = _bank(500, 32, 0)
    rng = np.random.default_rng(1)
    query = np.concatenate([bank[:20] + 0.05 * rng.standard_normal((20, 32)),
                            rng.standard_normal((20, 32)) * 2]).astype(np.float32)
    ref = np.asarray(jretrieval._retrieve_blend(jnp.asarray(query), jnp.asarray(bank), ratio, k))
    got = pretrieval.retrieve_blend(torch.from_numpy(query), torch.from_numpy(bank),
                                    ratio, k).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_equal_distances_take_jax_order():
    """A bank with repeated vectors: the k nearest include equal distances,
    taken lower index first as jax.lax.top_k takes them; the blend equals
    JAX's to the last bit on this exactly representable data."""
    base = np.array([[0, 0], [1, 0], [0, 2], [3, 3]], np.float32)
    bank = np.concatenate([base, base[::-1], base])
    query = np.array([[0.5, 0.0], [0.0, 1.0], [2.0, 2.0]], np.float32)
    for k in (2, 3, 5):
        ref = np.asarray(jretrieval._retrieve_blend(jnp.asarray(query), jnp.asarray(bank),
                                                    0.5, k))
        got = pretrieval.retrieve_blend(torch.from_numpy(query), torch.from_numpy(bank),
                                        0.5, k).numpy()
        np.testing.assert_array_equal(got, ref)


def test_create_retrieval_on_jax_banks(tmp_path):
    """Banks written by JAX's build_index from per-utterance feature files
    load into the port's create_retrieval (on the CPU) and blend like JAX's
    ArrayIndexRetrieval (1e-4, as above); disabled, it passes features
    through."""
    files = {"whisper": [], "hubert": []}
    for i in range(3):
        for name, d in (("whisper", 64), ("hubert", 16)):
            path = tmp_path / f"utt{i}.{name}.npy"
            np.save(path, _bank(50 + 10 * i, d, 10 * i + d))
            files[name].append(str(path))
    prefix = str(tmp_path / "spk_")
    for name in files:
        jretrieval.build_index(files[name], prefix + f"{name}.npz")
    np.testing.assert_array_equal(pretrieval.load_index(prefix + "whisper.npz"),
                                  jretrieval.load_index(prefix + "whisper.npz"))
    args = (True, 0.4, 4, prefix + "whisper.npz", prefix + "hubert.npz")
    ref, got = jretrieval.create_retrieval(*args), pretrieval.create_retrieval(*args,
                                                                                device="cpu")
    assert got.whisper_bank.device.type == "cpu" and got.whisper_bank.shape == (180, 64)
    rng = np.random.default_rng(5)
    ppg, vec = _bank(30, 64, 7), rng.standard_normal((30, 16)).astype(np.float32)
    np.testing.assert_allclose(got.retriv_whisper(ppg), ref.retriv_whisper(ppg),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.retriv_hubert(vec), ref.retriv_hubert(vec),
                               rtol=1e-4, atol=1e-4)
    off = pretrieval.create_retrieval(False, *args[1:], device="cpu")
    np.testing.assert_array_equal(off.retriv_whisper(ppg), ppg)
    with pytest.raises(ValueError, match="gte 1"):
        pretrieval.ArrayIndexRetrieval(ppg, vec, 0.5, 0, device="cpu")
    with pytest.raises(ValueError, match="in range"):
        pretrieval.ArrayIndexRetrieval(ppg, vec, 1.5, 3, device="cpu")


def test_port_bank_reads_in_jax(tmp_path):
    """The port's build_index writes the JAX package's .npz format."""
    path = tmp_path / "f.npy"
    np.save(path, _bank(40, 8, 3))
    bank = pretrieval.build_index([str(path)], str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(jretrieval.load_index(str(tmp_path / "b.npz")), bank)


def test_compress_features_matches_jax():
    """Above the threshold both packages run scipy's kmeans2 with the same
    seed: the same centroids; below it the features pass as float32."""
    feats = _bank(300, 4, 9).astype(np.float64)
    kw = dict(threshold=200, n_clusters=16, seed=3)
    got = pretrieval.compress_features(feats, **kw)
    assert got.shape == (16, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jretrieval.compress_features(feats, **kw))
    small = pretrieval.compress_features(feats[:100], **kw)
    np.testing.assert_array_equal(small, feats[:100].astype(np.float32))


def test_retrievals_are_iretrieval():
    """IRetrieval is the interface svc_infer calls, as in the JAX package:
    the dummy and the bank retrieval implement it, the base raises."""
    assert issubclass(pretrieval.DummyRetrieval, pretrieval.IRetrieval)
    assert issubclass(pretrieval.ArrayIndexRetrieval, pretrieval.IRetrieval)
    assert issubclass(jretrieval.ArrayIndexRetrieval, jretrieval.IRetrieval)
    x = np.ones((3, 4), np.float32)
    for name in ("retriv_whisper", "retriv_hubert"):
        with pytest.raises(NotImplementedError):
            getattr(pretrieval.IRetrieval(), name)(x)
        np.testing.assert_array_equal(getattr(pretrieval.DummyRetrieval(), name)(x),
                                      getattr(jretrieval.DummyRetrieval(), name)(x))
