"""Feature retrieval, RVC-style (JAX whisper_vits_svc_tpu/infer/retrieval.py;
reference feature_retrieval/index.py:57-94, transform.py:29-49,
svc_train_retrieval.py).

A speaker's bank holds its training features (hubert 256-d, whisper
1280-d), kmeans-compressed to 10k vectors when it has 200k or more. At
inference each chunk's features are blended with their k nearest bank
vectors: out = (1 - ratio) * x + ratio * sum(w_i * v_i), w ~ (1 / d^2)^2
normalised, d^2 the squared L2 distance. The search is exact, one [T, N]
distance matmul on the bank's device, in float32 with TF32 off
(d^2 = |q|^2 + |b|^2 - 2 q.b loses digits to cancellation already). Banks
are `.npz` files of raw vectors, the JAX package's format.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class IRetrieval:
    """What svc_infer asks of a retrieval: each chunk's PPG and units, blended."""

    def retriv_whisper(self, vec: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def retriv_hubert(self, vec: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class DummyRetrieval(IRetrieval):
    def retriv_whisper(self, vec: np.ndarray) -> np.ndarray:
        return np.asarray(vec, np.float32)

    def retriv_hubert(self, vec: np.ndarray) -> np.ndarray:
        return np.asarray(vec, np.float32)


def retrieve_blend(query: torch.Tensor, bank: torch.Tensor, ratio: float, k: int) -> torch.Tensor:
    """query [T, D], bank [N, D] -> blended [T, D]. The k nearest come in
    jax.lax.top_k's order: nearest first, the lower bank index first among
    equal distances (a stable sort)."""
    q2 = (query * query).sum(dim=1, keepdim=True)
    b2 = (bank * bank).sum(dim=1)
    d2 = q2 + b2[None, :] - (2.0 * query) @ bank.T  # squared L2, [T, N]
    d2_k, idx = torch.sort(d2, dim=1, stable=True)
    scores = d2_k[:, :k].clamp_min(1e-12)
    weight = (1.0 / scores).square()
    weight = weight / weight.sum(dim=1, keepdim=True)
    blended = (bank[idx[:, :k]] * weight[..., None]).sum(dim=1)
    return (1.0 - ratio) * query + ratio * blended


class ArrayIndexRetrieval(IRetrieval):
    """retriv() of FaissRVCRetrievableFeatureIndex (index.py:57-94), with
    both banks kept on `device` (the card by default)."""

    def __init__(self, whisper_bank: np.ndarray, hubert_bank: np.ndarray, ratio: float,
                 n_nearest: int, device: str | torch.device | None = "cuda"):
        if n_nearest < 1:
            raise ValueError("n-retrieval-vectors must be gte 1")
        if not (0 <= ratio <= 1):
            raise ValueError(f"{ratio=} must be in range (0, 1)")
        self.device = resolve_device(device)
        self.whisper_bank = torch.as_tensor(whisper_bank, dtype=torch.float32).to(self.device)
        self.hubert_bank = torch.as_tensor(hubert_bank, dtype=torch.float32).to(self.device)
        self.ratio = ratio
        self.k = n_nearest

    def _blend(self, vec: np.ndarray, bank: torch.Tensor) -> np.ndarray:
        query = torch.as_tensor(np.asarray(vec, np.float32)).to(self.device)
        with torch.inference_mode():
            return retrieve_blend(query, bank, self.ratio, self.k).cpu().numpy()

    def retriv_whisper(self, vec: np.ndarray) -> np.ndarray:
        return self._blend(vec, self.whisper_bank)

    def retriv_hubert(self, vec: np.ndarray) -> np.ndarray:
        return self._blend(vec, self.hubert_bank)


def compress_features(features: np.ndarray, threshold: int = 200_000,
                      n_clusters: int = 10_000, seed: int = 1234) -> np.ndarray:
    """kmeans compression of oversized feature banks (transform.py:29-49)."""
    if len(features) < threshold:
        return features.astype(np.float32)
    from scipy.cluster.vq import kmeans2

    centroids, _ = kmeans2(features.astype(np.float64), n_clusters, minit="points", seed=seed)
    return centroids.astype(np.float32)


def build_index(feature_files: list[str], out_path: str, **compress_kw) -> np.ndarray:
    """Per-utterance feature npys, stacked -> a compressed bank written to
    out_path as npz (svc_train_retrieval.py: one index per speaker and
    feature)."""
    feats = np.concatenate([np.load(f) for f in feature_files], axis=0)
    bank = compress_features(feats, **compress_kw)
    np.savez_compressed(out_path, bank=bank)
    return bank


def load_index(path: str) -> np.ndarray:
    return np.load(path)["bank"]


def create_retrieval(enable: bool, ratio: float, n_nearest: int,
                     whisper_index_path: str | None, hubert_index_path: str | None,
                     device: str | torch.device | None = "cuda"):
    """svc_inference.py:41-58: the pass-through unless enabled."""
    if not enable:
        return DummyRetrieval()
    return ArrayIndexRetrieval(load_index(whisper_index_path), load_index(hubert_index_path),
                               ratio, n_nearest, device=device)
