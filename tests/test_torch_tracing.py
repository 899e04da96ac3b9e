"""The port's spans (utils/profiling.py) on the CPU: off, a span is a shared
null context that builds no record_function and records nothing; on, under
a torch.profiler session, it records its id, parent, unit and Unix-clock
times and lands in the Chrome trace as a range of its name; self time is
the duration less what the children cover. StreamingSvc.push and the train
step make their span trees once per call, and tracing changes no output,
loss or parameter."""

import json

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.utils.testing import micro_hp, synthetic_batch
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils import profiling
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict
from whisper_vits_svc_tpu_torch.utils.profiling import Span, self_ns, span, spans

PUSH_CHILDREN = ["svc.push.prep", "svc.push.upload", "svc.push.source", "svc.push.forward",
                 "svc.push.readback"]
STEP_CHILDREN = ["svc.step.upload", "svc.step.g_forward", "svc.step.audio_losses",
                 "svc.step.kl", "svc.step.d_backward", "svc.step.g_backward",
                 "svc.step.update"]


def _since(last_id: int) -> list[Span]:
    return [s for s in spans() if s.id > last_id]


def _last_id() -> int:
    rec = spans()
    return max((s.id for s in rec), default=0)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_off_is_a_shared_null_context(monkeypatch):
    _no_record_function(monkeypatch)
    n = len(spans())
    a, b = span("svc.a", unit=1), profiling.annotate("svc.b")
    assert a is b
    with a:
        with span("svc.c"):
            torch.ones(4) * 2
    assert len(spans()) == n


def test_span_on_records_the_tree_and_the_trace(tmp_path):
    """Ids rise, children point at their parent and take its unit, times
    nest, self time is the duration less the children's, and the Chrome
    trace holds a user_annotation range of each name."""
    last = _last_id()

    def work():
        with span("svc.outer", unit=7):
            with span("svc.outer.a"):
                torch.ones(256) * 3
            torch.ones(256) + 1
            with span("svc.outer.b"):
                with span("svc.outer.b.c"):
                    torch.ones(256).sum()
        with span("svc.other"):
            pass

    _, prof = _profiled(work)
    rec = _since(last)
    by = {s.name: s for s in rec}
    assert [s.name for s in rec] == ["svc.outer.a", "svc.outer.b.c", "svc.outer.b", "svc.outer",
                                     "svc.other"]
    outer, a, b, c = by["svc.outer"], by["svc.outer.a"], by["svc.outer.b"], by["svc.outer.b.c"]
    assert outer.id < a.id < b.id < c.id < by["svc.other"].id
    assert (outer.parent, a.parent, b.parent, c.parent) == (None, outer.id, outer.id, b.id)
    assert (outer.unit, a.unit, b.unit, c.unit, by["svc.other"].unit) == (7, 7, 7, 7, None)
    for child, parent in ((a, outer), (b, outer), (c, b)):
        assert parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns
    dur = lambda s: s.t1_ns - s.t0_ns  # noqa: E731
    assert self_ns(outer, rec) == dur(outer) - dur(a) - dur(b)
    assert self_ns(b, rec) == dur(b) - dur(c)
    assert self_ns(c, rec) == dur(c)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ranges = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert sorted(ranges) == sorted(s.name for s in rec)


def test_self_time_clips_children_to_their_parent():
    """Children that overlap each other count once, and the part of a
    child outside its parent does not count."""
    p = Span("p", 1, None, 1, 100, 200)
    rec = [p, Span("a", 2, 1, 1, 110, 140), Span("b", 3, 1, 1, 130, 150),
           Span("c", 4, 1, 1, 190, 230), Span("x", 5, None, 1, 120, 180)]
    assert self_ns(p, rec) == 100 - 40 - 10


def test_record_is_bounded():
    assert profiling._record.maxlen == profiling.RECORD_LEN


@pytest.fixture(scope="module")
def micro_infer():
    hp = config_from_dict(micro_hp())
    return hp, pipeline.build_infer_model(hp, device="cpu", seed=3)


def _features(hp, t, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(hp.vits.spk_dim).astype(np.float32) * 0.5,
            (rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
            (rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32),
            rng.uniform(100, 400, t).astype(np.float32))


def _pushes(stream, ppg, vec, pit, block):
    return [stream.push(ppg[s : s + block], vec[s : s + block], pit[s : s + block])
            for s in range(0, len(pit), block)]


def test_push_makes_its_tree_once_per_push(micro_infer, monkeypatch):
    """Three pushes (the last short) under a profiler: one svc.push each,
    its unit the stream's push count, with the five children in order; the
    same pushes outside a session record nothing and build no range; the
    waveforms are bitwise the same either way."""
    hp, model = micro_infer
    spk, ppg, vec, pit = _features(hp, 27)
    make = lambda: StreamingSvc(model, spk, hp, block_frames=10, context_frames=5,  # noqa: E731
                                noise_scale=1.0, seed=11, device="cpu")
    last = _last_id()
    on, _ = _profiled(lambda: _pushes(make(), ppg, vec, pit, 10))
    rec = _since(last)
    pushes = [s for s in rec if s.name == "svc.push"]
    assert [s.unit for s in pushes] == [1, 2, 3]
    for p in pushes:
        kids = sorted((s for s in rec if s.parent == p.id), key=lambda s: s.t0_ns)
        assert [s.name for s in kids] == PUSH_CHILDREN
        assert all(s.unit == p.unit for s in kids)
    assert len(rec) == 3 * (1 + len(PUSH_CHILDREN))

    _no_record_function(monkeypatch)
    n = len(spans())
    off = _pushes(make(), ppg, vec, pit, 10)
    assert len(spans()) == n
    assert [len(a) for a in on] == [10 * hp.data.hop_length] * 2 + [7 * hp.data.hop_length]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def _run_steps(hp, batches, traced: bool):
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    step = tstep.make_train_step(hp, g_state, d_state)
    gen = torch.Generator().manual_seed(4)

    def run():
        return [step(b, gen) for b in batches]

    metrics = _profiled(run)[0] if traced else run()
    return metrics, g_state, d_state


def test_train_step_makes_its_tree_once_per_step():
    """Two steps (G updates on the second, accum_step 2) under a profiler:
    one svc.step each with unit 1, 2 and its seven children in order, D's
    forward inside the audio losses; the losses, grad norms and every
    parameter and AdamW moment bitwise equal to the same steps untraced."""
    hp = config_from_dict(micro_hp())
    batches = [synthetic_batch(hp, np.random.default_rng(i), b=2, t=20) for i in (1, 2)]
    last = _last_id()
    m_on, g_on, d_on = _run_steps(hp, batches, traced=True)
    rec = _since(last)
    steps = [s for s in rec if s.name == "svc.step"]
    assert [s.unit for s in steps] == [1, 2]
    for st in steps:
        kids = sorted((s for s in rec if s.parent == st.id), key=lambda s: s.t0_ns)
        assert [s.name for s in kids] == STEP_CHILDREN
        audio = kids[STEP_CHILDREN.index("svc.step.audio_losses")]
        assert [s.name for s in rec if s.parent == audio.id] == ["svc.step.d_forward"]
        assert all(s.unit == st.unit for s in rec if s.parent in (st.id, audio.id))
    assert len(rec) == 2 * (2 + len(STEP_CHILDREN))

    m_off, g_off, d_off = _run_steps(hp, batches, traced=False)
    for a, b in zip(m_on, m_off):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for on, off in ((g_on, g_off), (d_on, d_off)):
        for (name, p), q in zip(on.model.named_parameters(), off.model.parameters()):
            assert torch.equal(p, q), name
            for k, v in on.optimizer.state[p].items():
                w = off.optimizer.state[q][k]
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(w)), (name, k)
