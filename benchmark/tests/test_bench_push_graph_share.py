"""`push_graph_share.live` (metrics/push_graph_share.py) on synthetic push
units laid out as test_bench_program_spans.py lays them: 100 when every
push's forward holds a replay span, 50 when one of two does, 0 when none
does or the replay span is not inside the forward; None without spans,
without alignment, or from a program that has no graph counters."""

from types import SimpleNamespace

import pytest

from benchmark.harness import ROOT, reader
from benchmark.tests.test_bench_program_spans import PUSH, PUSH_KERNELS, Units
from benchmark.trace import program
from whisper_vits_svc_tpu_torch.infer import stream

METRIC = "push_graph_share.live"
REPLAY = [("svc.push.forward.replay", 420, 1400)]


def children(forward_inner, extra=()):
    return [(name, a, b, forward_inner if name == "svc.push.forward" else inner)
            for name, a, b, inner in PUSH] + list(extra)


def pushes(layouts):
    u = Units("bench.push", "svc.push", 10_000.0)
    for k, (ts, kids) in enumerate(zip((1000.0, 4000.0), layouts), start=1):
        u.unit(k, ts, 2000.0, 5.0, 1900.0, kids, PUSH_KERNELS)
    return u


STRAY = [("svc.push.forward.replay", 1850, 1860, [])]  # under svc.push, outside the forward


@pytest.mark.parametrize("layouts, expected", [
    ((children(REPLAY), children(REPLAY)), 100.0),
    ((children(REPLAY), children([])), 50.0),
    ((children([]), children([])), 0.0),
    ((children([], STRAY), children([], STRAY)), 0.0),
])
def test_share_of_replayed_pushes(layouts, expected, monkeypatch):
    value = reader(ROOT, METRIC)(pushes(layouts).ctx(monkeypatch))
    assert value == pytest.approx(expected, abs=1e-12)


def test_none_without_spans_or_counters(monkeypatch):
    u = pushes((children(REPLAY), children(REPLAY)))
    ctx = u.ctx(monkeypatch)
    read = reader(ROOT, METRIC)
    assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(stream, "graph_replays")
    assert read(ctx) is None
    monkeypatch.undo()
    ctx = u.ctx(monkeypatch)
    monkeypatch.setattr(program, "program_spans", lambda: [])
    assert read(ctx) is None
