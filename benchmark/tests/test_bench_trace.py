"""The trace and metric arithmetic on a hand-made Chrome trace and at known
shapes: idle share as a union of intervals, gaps labelled by the open host
op, base names, roofline and MFU sums, and FLOP counts that do not move when
the program's modules are swapped."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import ROOT, reader
from benchmark.reference.synth import SynthesizerInfer
from benchmark.tests.conftest import micro_model
from benchmark.trace.chrome import Trace, kernel_base_name, load_events
from benchmark.work import count_flops, snake_bound_s, stage_shapes

PEAKS = {"float32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


SNAKE = "void (anonymous namespace)::snake_alias_kernel<float>(float const*, float*, int)"
BWD = "void (anonymous namespace)::snake_alias_bwd_kernel<float>(float const*, int)"
EVENTS = [
    ev("bench.slice", "user_annotation", 1000, 1000),
    ev("bench.request", "user_annotation", 1010, 900),
    ev("aten::conv1d", "cpu_op", 1100, 300),
    ev("cudaLaunchKernel", "cuda_runtime", 1150, 20),
    ev("aten::copy_", "cpu_op", 1600, 250),
    # device: two overlapping kernels on two streams, a copy, one kernel
    # before the window and one across its end
    ev(SNAKE, "kernel", 1200, 100, tid=7),
    ev("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 1250, 100, tid=8),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500, 50, tid=7),
    ev(BWD, "kernel", 900, 150, tid=7),
    ev(SNAKE, "kernel", 1950, 100, tid=7),
    ev("bench.slice", "gpu_user_annotation", 1000, 1000, tid=7),
]


@pytest.fixture
def trace():
    return Trace(EVENTS, "bench.slice")


def test_busy_is_the_union_of_device_intervals(trace):
    # [1000,1050] + [1200,1350] + [1500,1550] + [1950,2000], clipped to the window
    assert trace.busy_s == pytest.approx((50 + 150 + 50 + 50) / 1e6)
    assert trace.window_s == pytest.approx(1000 / 1e6)
    idle = reader(ROOT, "device_idle_pct.song")(SimpleNamespace(trace=trace))
    assert idle == pytest.approx(70.0)


def test_gaps_are_labelled_by_the_open_host_op(trace):
    gaps = trace.top_gaps()
    assert [g[1] for g in gaps] == pytest.approx([400e-6, 150e-6, 150e-6])
    assert gaps[0][0] == "bench.request > aten::copy_"  # [1550, 1950], middle 1750
    labels = {g[0] for g in gaps[1:]}  # [1050, 1200] middle 1125, [1350, 1500] middle 1425
    assert labels == {"bench.request > aten::conv1d", "bench.request > python"}


def test_base_names_and_kernel_time(trace):
    assert kernel_base_name(SNAKE) == "snake_alias_kernel<float>"
    assert kernel_base_name("void at::native::(anonymous namespace)::k<int, 3>(x)") == "k<int, 3>"
    assert trace.kernel_s(("snake_alias_kernel",)) == pytest.approx(150e-6)  # 100 + 50 clipped
    assert trace.kernel_s(("snake_alias_bwd",)) == pytest.approx(50e-6)
    assert trace.top_ops()[0] == ["snake_alias_kernel<float>", pytest.approx(150e-6)]


def test_trace_file_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert Trace(load_events(str(path)), "bench.slice").busy_s == pytest.approx(300e-6)


def test_snake_roofline_at_known_shapes(trace):
    mc = micro_model()
    shapes = stage_shapes(mc, 2, 10)
    # hop 8 over rates 4, 2; 2 kernels x 2 dilations x 2 snakes a stage, + post
    assert shapes == [((2, 8, 40), 8), ((2, 4, 80), 9)]
    fwd = sum(c * max((2 * b * ch * t + 2 * ch) * 4 / 3.35e12, 58 * b * ch * t / 67e12)
              for (b, ch, t), c in shapes)
    bwd = sum(c * max((3 * b * ch * t + 4 * ch) * 4 / 3.35e12, 102 * b * ch * t / 67e12)
              for (b, ch, t), c in shapes)
    assert snake_bound_s(shapes, PEAKS) == pytest.approx(fwd)
    assert snake_bound_s(shapes, PEAKS, backward=True) == pytest.approx(bwd)
    ctx = SimpleNamespace(trace=trace, peaks=PEAKS,
                          work=dict(snake_fwd_calls=shapes, snake_bwd_calls=shapes))
    assert reader(ROOT, "snake_fwd_roofline.song")(ctx) == pytest.approx(100 * fwd / 150e-6)
    assert reader(ROOT, "snake_bwd_roofline.train")(ctx) == pytest.approx(100 * bwd / 50e-6)


def test_readers_find_nothing_to_read():
    empty = SimpleNamespace(trace=None, peaks=PEAKS, work=dict(snake_fwd_calls=[]))
    for m in ("device_idle_pct.song", "snake_fwd_roofline.live", "snake_bwd_roofline.train"):
        assert reader(ROOT, m)(empty) is None
    no_snake = Trace([e for e in EVENTS if "snake" not in e["name"]], "bench.slice")
    ctx = SimpleNamespace(trace=no_snake, peaks=PEAKS, work=dict(snake_fwd_calls=[((1, 1, 1), 1)]))
    assert reader(ROOT, "snake_fwd_roofline.song")(ctx) is None


def test_mfu_sum():
    ctx = SimpleNamespace(trace=None, peaks={"float32_flops_per_s": 67e12},
                          work=dict(flops=6.7e12, wall_s=2.0, precision="float32"))
    assert reader(ROOT, "mfu.train")(ctx) == pytest.approx(5.0)
    ctx.peaks = {}
    assert reader(ROOT, "mfu.train")(ctx) is None


def test_flop_count_of_a_known_convolution():
    conv = torch.nn.Conv1d(6, 10, 5, padding=2)
    assert count_flops(lambda: conv.to("meta")(torch.zeros(3, 6, 40))) == 2 * 3 * 10 * 40 * 6 * 5


def test_flop_count_ignores_the_program(monkeypatch):
    """The count runs the reference: swapping the program's convolutions and
    snake for other code leaves it unchanged."""
    from whisper_vits_svc_tpu_torch.nn import conv as prog_conv
    from whisper_vits_svc_tpu_torch.ops import snake_cuda

    mc = micro_model()
    v = mc["vits"]

    def chunk():
        ref = SynthesizerInfer(mc)
        return ref(torch.zeros(1, 24, v["ppg_dim"]), torch.zeros(1, 24, v["vec_dim"]),
                   torch.zeros(1, 24), torch.zeros(1, v["spk_dim"]), torch.full((1,), 24),
                   torch.zeros(1, 24 * 8, 1), 1.0, torch.zeros(1, 24, v["inter_channels"]))

    before = count_flops(chunk)
    monkeypatch.setattr(prog_conv.Conv1d, "forward", lambda self, x: x)
    monkeypatch.setattr(snake_cuda, "snake_alias", lambda *a, **k: None)
    assert count_flops(chunk) == before > 0
