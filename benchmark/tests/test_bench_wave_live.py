"""The `wave_live` driver at micro widths on the CPU (its own configuration,
`micro_wave.json`: a narrow hop-320 synthesizer behind whisper 2 x 64,
HuBERT-soft with one layer and CREPE "tiny"): a run is correct, and each
planted fault fails its own check and no other, and the decode faults
take the place of the pitch; the wave cell's readers on hand-made spans
and a hand-made trace, and None without the program's spans; the
recording's levels; the FLOP count a push."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.drivers.wave_live import DECODE_FAULTS, FAULTS, decode, flips, late
from benchmark.harness import ROOT, driver_class, load_cell, reader, run_cell
from benchmark.reference import extract as rx
from benchmark.tests.test_bench_program_spans import OFFSET_NS, Units
from benchmark.trace import program
from benchmark.traffic.audio import recording
from benchmark.work_extract import crepe_flops, crepe_frames_of_push

HERE = Path(__file__).resolve().parent
CELL = {"config": "micro_wave", "driver": "wave_live",
        "traffic": {"recording_seconds": 2, "block_frames": 20, "context_frames": 10,
                    "noise_scale": 1.0, "warm_pushes": 2},
        "limits": {"ppg_max_abs": 1e-4, "vec_max_abs": 1e-4, "crepe_prob_max_abs": 1e-5,
                   "pit_flip_frames": 0.5, "block_max_abs": 1e-5}}
CHECK_OF = {"ppg": "ppg_max_abs", "vec": "vec_max_abs", "crepe": "crepe_prob_max_abs",
            "pit": "pit_flip_frames", "block": "block_max_abs"}


@pytest.fixture(scope="module")
def wave_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("wave") / "benchmark"
    shutil.copytree(HERE.parent, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(HERE / "micro_wave.json", root / "configs" / "micro_wave.json")
    (root / "workloads" / "micro-wave-live.json").write_text(json.dumps(CELL))
    (root.parent / "BENCHMARK.json").write_text(json.dumps({"per_layer": []}))
    return root


@pytest.fixture(scope="module")
def ran(wave_root):
    """A driver after 14 pushes (the 2 s recording loops after 10)."""
    cell = load_cell("micro-wave-live", wave_root)
    drv = driver_class(cell)(cell, 2**31 + 77, "cpu")
    drv.setup()
    records = [drv.unit() for _ in range(14)]
    drv.release()
    return drv, records


def test_run_cell_is_correct(wave_root):
    res = run_cell("micro-wave-live", 2**33 + 5, 1.0, False, "cpu", root=wave_root)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["checks"]) == set(CHECK_OF.values())
    assert res["metrics"]["live_block_p95_ms"]["value"] > 0


@pytest.mark.parametrize("kind", FAULTS)
def test_a_planted_fault_fails_its_check(ran, kind):
    drv, records = ran
    saved = (list(drv.emitted), list(drv.crepe_probs), list(drv.outputs), drv.fed)
    try:
        drv.plant(kind)
        checks = {n: (v, lim) for n, v, lim in drv.check(records)}
    finally:
        drv.emitted, drv.crepe_probs, drv.outputs, drv.fed = (list(saved[0]), list(saved[1]),
                                                               list(saved[2]), saved[3])
    failed = {n for n, (v, lim) in checks.items() if not v <= lim}
    assert failed == {CHECK_OF[kind]}


@pytest.mark.parametrize("kind", DECODE_FAULTS)
def test_a_decode_fault_takes_the_place_of_the_pitch(ran, kind):
    """At micro widths the seeded CREPE's path sits on one bin, where these
    faults change nothing (reference/extract.py's CPU test shows them
    flipping frames on a path that moves): here, that the planted pitch is
    the faulty one, push by push."""
    drv, _ = ran
    saved = (list(drv.emitted), drv.fed)
    try:
        before = [e[2] for e in drv.emitted]
        drv.plant(kind)
        after = [e[2] for e in drv.emitted]
    finally:
        drv.emitted, drv.fed = saved
    assert [len(a) for a in after] == [len(b) for b in before]
    if kind == "lag":
        np.testing.assert_array_equal(np.concatenate(after),
                                      np.concatenate(late(before)))
    else:
        pushed = [(k + 1) * drv.block for k in range(len(before))]
        want = decode(rx.observations(torch.from_numpy(np.concatenate(drv.crepe_probs))),
                      [rx.crepe_head(t) for t in pushed], [t // 320 - 4 for t in pushed],
                      filter_frames=1)
        np.testing.assert_array_equal(np.concatenate(after), np.concatenate(want))


def test_the_unaltered_run_passes_and_the_control_reads_its_precision(ran):
    drv, records = ran
    checks = {n: v for n, v, lim in drv.check(records)}
    assert all(v <= CELL["limits"][n] for n, v in checks.items()), checks
    # on the CPU TF32 does nothing: the control reads the reference against itself
    assert all(v == 0.0 for v in {n: v for n, v, _ in drv.check(records, "control")}.values())
    assert drv.diag["pushes"] == 14 and drv.diag["crepe_frames"] == 14 * 10 - 1


def test_flips():
    want = np.array([100.0, 200.0, 0.0, 300.0])
    assert flips(want, want) == 0
    assert flips(want * 2 ** (0.9 / 1200), want) == 0
    assert flips(want * 2 ** (1.1 / 1200), want) == 3
    assert flips(np.where(want > 0, want, 150.0), want) == 1
    assert flips(want[:3], want) == 4


EXTRACT = [("svc.extract", 0, 6000, [("svc.extract.whisper", 0, 3000),
                                     ("svc.extract.hubert", 3000, 4000),
                                     ("svc.extract.crepe", 4000, 5500),
                                     ("svc.extract.emit", 5500, 6000)]),
           ("svc.push", 6000, 8000, [("svc.push.forward", 6100, 7000)])]
KERNELS = [(500, 2500), (3200, 3900), (4100, 4600), (6500, 7900)]


def units(lags=(5.0, 9.0)):
    """Two pushes of 8 ms: whisper 3 ms with 2 ms of kernels, HuBERT 1 ms
    with 0.7, CREPE 1.5 ms with 0.5 (then its host trellis), the emit
    0.5 ms with none; extract 6 ms with 3.2 ms of kernels; then the
    synthesis push, 2 ms, its forward 0.9 ms with 0.5 of kernels (the
    first push's a graph replay), its self time 1.1 ms with 0.9."""
    u = Units("bench.push_audio", "svc.push_audio", 30_000.0)
    for k, (ts, lag) in enumerate(zip((1000.0, 12_000.0), lags), start=1):
        u.unit(k, ts, 9000.0, lag, 8000.0, EXTRACT, KERNELS)
    forward = next(s for s in u.record if s.name == "svc.push.forward")
    u.span("svc.push.forward.replay", forward.id, 1, (forward.t0_ns - OFFSET_NS) / 1e3,
           (forward.t1_ns - OFFSET_NS) / 1e3)
    return u


@pytest.mark.parametrize("metric, expected", [
    ("extract_ms.wave-live", 6.0), ("extract_idle_ms.wave-live", 2.8),
    # 1e9 FLOPs a window in 2 ms of busy time against 1e12 FLOP/s: 50%
    ("whisper_roofline.wave-live", 50.0),
    # the synthesis push within the wave push, as the live cell reads it:
    # 0.4 and 0.2 ms a push, moved by 5 us at the forward's kernel edge,
    # since the alignment takes the smallest lag (5 us) as none
    ("push_forward_idle_ms.wave-live", 0.405), ("push_prep_idle_ms.wave-live", 0.195),
    ("push_graph_share.wave-live", 50.0)])
def test_reader_on_a_hand_made_trace(metric, expected, monkeypatch):
    ctx = units().ctx(monkeypatch)
    ctx.work = dict(whisper_flops=1e9, precision="float32")
    ctx.peaks = {"float32_flops_per_s": 1e12}
    assert reader(ROOT, metric)(ctx) == pytest.approx(expected, rel=1e-9)


@pytest.mark.parametrize("metric", ["extract_ms.wave-live", "extract_idle_ms.wave-live",
                                    "whisper_roofline.wave-live",
                                    "push_forward_idle_ms.wave-live",
                                    "push_prep_idle_ms.wave-live", "push_graph_share.wave-live"])
def test_reader_without_the_programs_spans_gives_none(metric, monkeypatch):
    """No spans at all, a trace-less slice, and a program whose push_audio
    opens no span of its own (the parent's: only `svc.push` inside)."""
    u = units()
    ctx = u.ctx(monkeypatch)
    ctx.work = dict(whisper_flops=1e9, precision="float32")
    ctx.peaks = {"float32_flops_per_s": 1e12}
    read = reader(ROOT, metric)
    inner = [s for s in u.record if s.name.startswith("svc.push")
             and s.name != "svc.push_audio"]
    monkeypatch.setattr(program, "program_spans", lambda: inner)
    assert read(ctx) is None
    monkeypatch.setattr(program, "program_spans", lambda: [])
    assert read(ctx) is None
    assert read(SimpleNamespace(trace=None, work=ctx.work, peaks=ctx.peaks)) is None


def test_recording_levels():
    p = {"recording_seconds": 20}
    a, b = recording(p, 2**40 + 3, "cpu"), recording(p, 2**40 + 3, "cpu")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (20 * 16000,) and a.dtype == np.float32
    assert np.abs(a).max() == pytest.approx(0.5, rel=1e-6)
    quiet = np.abs(a) < 1e-2
    rms = float(np.sqrt(np.mean(np.square(a[quiet]))))
    assert 0.5e-3 < rms < 2e-3  # the rests at -60 dBFS
    assert 0.1 < quiet.mean() < 0.5
    assert not np.array_equal(a, recording(p, 2**40 + 4, "cpu"))


def test_crepe_frames_and_flops_of_a_push():
    assert [crepe_frames_of_push(k, 16000) for k in range(3)] == [49, 50, 50]
    assert crepe_flops("tiny", 50) == 50 * crepe_flops("tiny", 1)
