"""The program's spans on the device trace's axis (trace/program.py) and the
six readers built on them: a planted clock offset recovered within the
spread from synthetic push and step units (the step's driver range running
on past the program's span, as the driver's read-back does), the refusals
(a unit span outside its range, a spread over 200 us, no spans, a program
that keeps none), the idle milliseconds of each reader on a hand-made trace,
and the real spans of a micro-width live cell lining up with the real
trace on the CPU."""

import sys
import types
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import ROOT, driver_class, load_cell, module_spans, reader
from benchmark.tests.conftest import add_cell
from benchmark.trace import program
from benchmark.trace.chrome import Trace, load_events
from whisper_vits_svc_tpu_torch.utils.profiling import Span, spans

OFFSET_NS = 1_790_000_000_123_456_789  # the Unix clock less the trace's axis


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


class Units:
    """Synthetic units: driver ranges on the trace and program spans on the
    Unix clock, each laid out relative to the program unit's true start."""

    def __init__(self, bench, prog, window_us):
        self.bench, self.prog = bench, prog
        self.events = [ev("bench.slice", "user_annotation", 0.0, window_us)]
        self.record: list[Span] = []
        self.next_id = 1

    def span(self, name, parent, unit, a_us, b_us):
        s = Span(name, self.next_id, parent, unit, round(a_us * 1e3) + OFFSET_NS,
                 round(b_us * 1e3) + OFFSET_NS)
        self.next_id += 1
        self.record.append(s)
        return s

    def unit(self, k, ts, dur, lag, length, children, kernels):
        """Driver range [ts, ts + dur]; the program unit opens `lag` us in
        and lasts `length`; children (name, a, b, grandchildren) and kernels
        (a, b) relative to the program unit's start."""
        self.events.append(ev(self.bench, "user_annotation", ts, dur))
        p = ts + lag
        top = self.span(self.prog, None, k, p, p + length)
        for name, a, b, inner in children:
            c = self.span(name, top.id, k, p + a, p + b)
            for name2, a2, b2 in inner:
                self.span(name2, c.id, k, p + a2, p + b2)
        self.events += [ev("kernel_x", "kernel", p + a, b - a) for a, b in kernels]

    def ctx(self, monkeypatch):
        monkeypatch.setattr(program, "program_spans", lambda: list(self.record))
        return SimpleNamespace(trace=Trace(self.events, "bench.slice"))


PUSH = [("svc.push.prep", 10, 110, []), ("svc.push.upload", 110, 210, []),
        ("svc.push.source", 210, 410, []), ("svc.push.forward", 410, 1410, []),
        ("svc.push.readback", 1410, 1810, [])]
PUSH_KERNELS = [(250, 350), (500, 900), (1000, 1300)]  # in source, forward, forward


def pushes(lags=(5.0, 12.0), length=1900.0):
    u = Units("bench.push", "svc.push", 10_000.0)
    for k, (ts, lag) in enumerate(zip((1000.0, 4000.0), lags), start=1):
        u.unit(k, ts, 2000.0, lag, length, PUSH, PUSH_KERNELS)
    return u


STEP = [("svc.step.upload", 10, 60, []), ("svc.step.g_forward", 60, 1060, []),
        ("svc.step.audio_losses", 1060, 1560, [("svc.step.d_forward", 1100, 1400)]),
        ("svc.step.kl", 1560, 1660, []), ("svc.step.d_backward", 1700, 2700, []),
        ("svc.step.g_backward", 2700, 4200, []), ("svc.step.update", 4200, 4900, [])]
STEP_KERNELS = [(100, 900), (1150, 1350), (1800, 2600), (2800, 4100), (4300, 4400)]


def steps():
    """svc.step lasts 5 ms of an 8 ms driver range: the rest is the
    driver's read-back of the losses."""
    u = Units("bench.step", "svc.step", 20_000.0)
    for k, (ts, lag) in enumerate(zip((1000.0, 10_000.0), (3.0, 40.0)), start=1):
        u.unit(k, ts, 8000.0, lag, 5000.0, STEP, STEP_KERNELS)
    return u


@pytest.mark.parametrize("units, min_lag, spread", [(pushes, 5.0, 7.0), (steps, 3.0, 37.0)])
def test_alignment_recovers_the_planted_offset(units, min_lag, spread, monkeypatch):
    u = units()
    ctx = u.ctx(monkeypatch)
    al = program.slice_units(ctx, u.bench, u.prog)
    assert al.offset_ns == OFFSET_NS + round(min_lag * 1e3)
    assert al.spread_us == pytest.approx(spread)
    assert len(al.units) == 2 and len(al.spans) == len(u.record)
    for s, (a, b) in al.units:  # each opens inside its range, within the spread
        assert 0 <= al.to_us(s.t0_ns) - a <= spread and al.to_us(s.t1_ns) <= b


def test_alignment_refuses_a_unit_outside_its_range(monkeypatch):
    u = pushes(length=2000.0)  # the unit with lag 12 closes 5 us past its range
    assert program.slice_units(u.ctx(monkeypatch), "bench.push", "svc.push") is None


def test_alignment_refuses_a_wide_spread(monkeypatch):
    u = pushes(lags=(5.0, 5.0 + 201.0), length=1500.0)
    assert program.slice_units(u.ctx(monkeypatch), "bench.push", "svc.push") is None
    u = pushes(lags=(5.0, 5.0 + 199.0), length=1500.0)
    assert program.slice_units(u.ctx(monkeypatch), "bench.push", "svc.push") is not None


LIVE = {"push_forward_ms.live": 1.0, "push_forward_idle_ms.live": 0.3,
        "push_prep_idle_ms.live": 0.4}
TRAIN = {"step_forward_idle_ms.train": 0.65, "step_backward_idle_ms.train": 0.4,
         "step_update_idle_ms.train": 0.6}


@pytest.mark.parametrize("units, metric, expected", [
    *((pushes, m, v) for m, v in LIVE.items()), *((steps, m, v) for m, v in TRAIN.items())])
def test_reader_on_a_hand_made_trace(units, metric, expected, monkeypatch):
    """Per push: forward 1000 us less 400 + 300 of kernels; prep 100 +
    upload 100 + source 200 - 100 + svc.push's self time 10 + 90. Per step:
    upload 50 + g_forward 1000 - 800 + audio losses 500 - 200 + kl 100;
    backward 1000 - 800 + 1500 - 1300; update 700 - 100."""
    value = reader(ROOT, metric)(units().ctx(monkeypatch))
    assert value == pytest.approx(expected, abs=1e-9)


@pytest.mark.parametrize("metric", [*LIVE, *TRAIN])
def test_reader_without_spans_gives_none(metric, monkeypatch):
    u = pushes() if metric in LIVE else steps()
    ctx = u.ctx(monkeypatch)
    read = reader(ROOT, metric)
    monkeypatch.setattr(program, "program_spans", lambda: [])
    assert read(ctx) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper_vits_svc_tpu_torch.utils.profiling",
                        types.ModuleType("whisper_vits_svc_tpu_torch.utils.profiling"))
    assert program.program_spans() is None


def test_fewer_program_units_than_ranges(monkeypatch):
    u = pushes()
    u.record = [s for s in u.record if s.unit == 2]
    assert program.slice_units(u.ctx(monkeypatch), "bench.push", "svc.push") is None


def test_real_spans_line_up_with_the_real_trace(micro_root, tmp_path):
    """A micro-width live cell's pushes under torch.profiler on the CPU:
    the program's svc.push spans pair with the driver's bench.push ranges
    within 200 us, each lands within that of its own range in the trace,
    and with no device operation every push's forward is idle time."""
    add_cell(micro_root, "micro-live")
    cell = load_cell("micro-live", micro_root)
    drv = driver_class(cell)(cell, 2**31 + 5, "cpu")
    drv.setup()
    n = 5
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            module_spans(drv.spans()):
        with torch.profiler.record_function("bench.slice"):
            for _ in range(n):
                drv.unit()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    events = load_events(path)
    trace = Trace(events, "bench.slice")
    al = program.align(trace, spans(), "bench.push", "svc.push")
    assert al is not None and len(al.units) == n
    assert al.spread_us < program.MAX_SPREAD_US
    own = sorted(e["ts"] for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == "svc.push")
    for (s, _), ts in zip(al.units, own):
        assert abs(al.to_us(s.t0_ns) - ts) < program.MAX_SPREAD_US
    forward = [s for s in al.spans if s.name == "svc.push.forward"]
    assert len(forward) == n
    got = program.idle_ms_per_unit(SimpleNamespace(trace=trace), "bench.push", "svc.push",
                                   ("svc.push.forward",))
    assert got == pytest.approx(sum(s.t1_ns - s.t0_ns for s in forward) / 1e6 / n, rel=1e-6)
