"""The streaming extractors' spans and counters (infer/stream_extract.py,
infer/stream.py) on the CPU, with micro extractors (whisper 2 x 64 with 4
heads, HuBERT-soft with 1 layer, CREPE "tiny") in front of a narrow hop-320
synthesizer: push_audio and flush_audio make their span trees once a call,
in order; the counters add up to the stream's windows and frames, the rows
to the frames rounded up to CREPE's static batch; tracing changes no
output."""

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer import stream_extract as se
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.models.crepe import Crepe
from whisper_vits_svc_tpu_torch.models.hubert import HubertSoft
from whisper_vits_svc_tpu_torch.models.whisper import WhisperEncoder
from whisper_vits_svc_tpu_torch.ops import viterbi_cuda
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict
from whisper_vits_svc_tpu_torch.utils.profiling import spans

SR = 16000
BLOCK = SR // 2  # 25 frames of 320 a push
PUSH_CHILDREN = ["svc.push.prep", "svc.push.upload", "svc.push.source", "svc.push.forward",
                 "svc.push.readback"]
EXTRACT_CHILDREN = ["svc.extract.whisper", "svc.extract.hubert", "svc.extract.crepe",
                    "svc.extract.emit"]


@pytest.fixture(scope="module")
def parts():
    """(hp, synthesizer, whisper, hubert, crepe), seeded, on the CPU."""
    hp = micro_hp()
    hp.data.update(hop_length=320, sampling_rate=32000, filter_length=256)
    hp.vits.update(ppg_dim=64, vec_dim=256)
    hp.gen.update(upsample_rates=[5, 4, 4, 2, 2], upsample_kernel_sizes=[15, 8, 8, 4, 4],
                  upsample_initial_channel=32)
    hp = config_from_dict(hp)
    torch.manual_seed(0)
    model = pipeline.build_infer_model(hp, device="cpu")
    whisper = WhisperEncoder(n_state=64, n_head=4, n_layer=2).eval()
    hubert = HubertSoft(n_layers=1).eval()
    crepe = Crepe("tiny").eval()
    return hp, model, whisper, hubert, crepe


def _voice(seconds, seed=3):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(220.0 * (1.0 + 0.3 * t / seconds)) / SR
    noise = np.random.default_rng(seed).standard_normal(n) * 0.005
    return (0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase) + noise).astype(np.float32)


def _stream(parts):
    hp, model, whisper, hubert, crepe = parts
    spk = (np.random.default_rng(8).standard_normal(hp.vits.spk_dim) * 0.1).astype(np.float32)
    svc = StreamingSvc(model, spk, hp, block_frames=50, context_frames=25, noise_scale=1.0,
                       seed=5, device="cpu")
    svc.attach_extractor(se.StreamingExtractor(whisper, hubert, crepe, block_samples=BLOCK,
                                               device="cpu"))
    return svc


def _run(parts, audio, profiled: bool):
    svc = _stream(parts)

    def go():
        outs = [svc.push_audio(audio[s : s + BLOCK]) for s in range(0, len(audio), BLOCK)]
        return outs + [svc.flush_audio()]

    if not profiled:
        return go()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        return go()


def _kids(rec, parent):
    return sorted((s for s in rec if s.parent == parent.id), key=lambda s: s.t0_ns)


def test_push_audio_and_flush_make_their_trees(parts):
    """Three pushes and the flush under a profiler: one svc.push_audio each,
    its unit the stream's count, holding svc.extract then svc.push; the
    push's extract runs the four stages in order, CREPE's holding its
    probabilities, then its trellis; the flush's runs CREPE (its tail
    frames, with the same two children) and the emit; svc.push keeps its
    own five children."""
    audio = _voice(1.5)
    last = max((s.id for s in spans()), default=0)
    _run(parts, audio, profiled=True)
    rec = [s for s in spans() if s.id > last]
    units = sorted((s for s in rec if s.name == "svc.push_audio"), key=lambda s: s.t0_ns)
    assert [s.unit for s in units] == [1, 2, 3, 4]
    for i, u in enumerate(units):
        assert [s.name for s in _kids(rec, u)] == ["svc.extract", "svc.push"]
        extract, push = _kids(rec, u)
        stages = _kids(rec, extract)
        assert [s.name for s in stages] == (EXTRACT_CHILDREN if i < 3 else
                                            ["svc.extract.crepe", "svc.extract.emit"])
        crepe = next(s for s in stages if s.name == "svc.extract.crepe")
        assert [s.name for s in _kids(rec, crepe)] == ["svc.extract.crepe.probs",
                                                      "svc.extract.crepe.trellis"]
        assert [s.name for s in _kids(rec, push)] == PUSH_CHILDREN
        assert all(s.unit == u.unit for s in (extract, *stages))
        assert u.t0_ns <= extract.t0_ns <= extract.t1_ns <= push.t0_ns <= push.t1_ns <= u.t1_ns
    per_push = 1 + 1 + 4 + 2 + 1 + len(PUSH_CHILDREN)
    per_flush = 1 + 1 + 2 + 2 + 1 + len(PUSH_CHILDREN)
    assert len(rec) == 3 * per_push + per_flush


def test_tracing_changes_no_output(parts):
    """The same stream with tracing on and off: every block, the flush's
    among them, the same to the bit; off, no span is recorded."""
    audio = _voice(1.5, seed=4)
    on = _run(parts, audio, profiled=True)
    n = len(spans())
    off = _run(parts, audio, profiled=False)
    assert len(spans()) == n
    assert [len(a) for a in on] == [len(a) for a in off]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_counters_add_up(parts):
    """Per push: a whisper and a HuBERT window each; CREPE's frames are
    those the stream completed (49 ... head + 1 over the stream, the tail at
    the flush), its rows the frames of each call rounded up to the static
    batch of 64; no trellis launch on the card."""
    audio = _voice(2.0, seed=5)
    svc = _stream(parts)
    ex = svc.extractor
    calls, launches = [], viterbi_cuda.counts()
    for s in range(0, len(audio), BLOCK):
        before, head = se.counts(), ex.crepe.head
        svc.push_audio(audio[s : s + BLOCK])
        calls.append((before, se.counts(), ex.crepe.head - head))
    before, head = se.counts(), ex.crepe.head
    svc.flush_audio()
    calls.append((before, se.counts(), ex.crepe.head - head))
    for i, (a, b, frames) in enumerate(calls):
        d = {k: b[k] - a[k] for k in b}
        pushed = i < len(calls) - 1
        assert d["whisper_windows"] == d["hubert_windows"] == int(pushed)
        assert d["crepe_frames"] == frames > 0
        assert d["crepe_rows"] == -(-frames // 64) * 64
    assert ex.crepe.head + 1 == len(audio) // se.HOP + 1
    assert viterbi_cuda.counts() == launches


def test_add_counts_adds_to_counts():
    before = se.counts()
    se.add_counts({"crepe_rows": 64, "whisper_windows": 2})
    after = se.counts()
    se.add_counts({"crepe_rows": -64, "whisper_windows": -2})
    assert after == before | {"crepe_rows": before["crepe_rows"] + 64,
                              "whisper_windows": before["whisper_windows"] + 2}
    assert se.counts() == before
