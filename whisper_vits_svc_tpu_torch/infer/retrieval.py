"""Feature retrieval interface. Only the pass-through `DummyRetrieval` is
ported; the retrieval banks (whisper_vits_svc_tpu/infer/retrieval.py) are
later work."""

from __future__ import annotations

import numpy as np


class DummyRetrieval:
    def retriv_whisper(self, vec: np.ndarray) -> np.ndarray:
        return np.asarray(vec, np.float32)

    def retriv_hubert(self, vec: np.ndarray) -> np.ndarray:
        return np.asarray(vec, np.float32)
