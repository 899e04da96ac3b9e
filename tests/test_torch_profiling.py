"""The port's profiling hooks and device-trace readers on the CPU, the
counterpart of tests/test_observability.py::test_step_timer: StepTimer's
window, trace(None) as a no-op, annotate's region in a written trace, and
the device_trace functions on a trace with kernel spans."""

import gzip
import json
import os

import torch

from whisper_vits_svc_tpu.utils.profiling import StepTimer as JStepTimer
from whisper_vits_svc_tpu_torch.utils import device_trace
from whisper_vits_svc_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_step_timer():
    """The JAX test's steps: a window of 3 over 5 steps, a positive mean; the
    same window behaviour as the JAX class on the same calls."""
    t, jt = StepTimer(window=3), JStepTimer(window=3)
    for _ in range(5):
        for timer in (t, jt):
            timer.start()
        x = torch.ones(10) * 2
        dt = t.stop(x)
        jt.stop()
        assert dt > 0
    assert len(t.times) == len(jt.times) == 3 and t.mean > 0
    assert t.times[-1] == dt
    assert StepTimer().mean == 0.0
    with trace(None) as prof:  # no-op path
        with annotate("region"):
            pass
    assert prof is None


def _trace_file(log_dir):
    (name,) = os.listdir(log_dir)
    assert name.endswith(".pt.trace.json")
    return os.path.join(log_dir, name)


def test_trace_writes_annotated_regions(tmp_path):
    """trace(dir) writes one Chrome trace holding the annotated region and
    the operators inside it; on the CPU it holds no kernel, so every
    device_trace reader returns None for it."""
    with trace(str(tmp_path)):
        with annotate("svc_region"):
            torch.ones(64) * 3
    with open(_trace_file(tmp_path)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "svc_region" and e.get("cat") == "user_annotation"
               for e in events)
    assert any(str(e.get("name", "")).startswith("aten::mul") for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)
    assert device_trace.device_ms_per_call(str(tmp_path), "aten::mul") is None
    assert device_trace.device_total_ms(str(tmp_path), ("aten",)) is None
    assert device_trace.measure_device_ms(lambda: torch.ones(8) * 2, "aten") is None
    assert device_trace.measure_device_total_ms(lambda: torch.ones(8) * 2, ("aten",)) is None


def _write(path, events, gz=False):
    data = json.dumps({"traceEvents": events})
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.write(data)


def test_device_trace_reads_kernel_spans(tmp_path):
    """Kernel spans only (category "kernel"), matched on the base name (less
    the return type and the namespaces, as the card's trace names B1); the
    newest trace of the directory; gzip too; None for a missing trace or no
    match."""
    snake = ("void (anonymous namespace)::snake_alias_kernel<float>(float const*, float*, "
             "float const*, float const*, snake_alias::Taps, int, int, int, long long)")
    events = [
        {"ph": "X", "cat": "kernel", "name": snake, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": snake, "dur": 14.0},
        {"ph": "X", "cat": "kernel", "name": "void snake_alias_bwd_kernel<float>()",
         "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel"
         "<4, at::native::snake_alias_like>(int)", "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "dur": 7.0},
        {"ph": "X", "cat": "cpu_op", "name": "snake_alias", "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 3.0},
        {"ph": "i", "cat": "kernel", "name": snake},
    ]
    d = str(tmp_path)
    assert device_trace.device_ms_per_call(d, "snake_alias") is None  # no trace yet
    _write(tmp_path / "a_1.100.pt.trace.json", [events[3]])
    _write(tmp_path / "a_1.200.pt.trace.json.gz", events, gz=True)  # the newest
    assert device_trace.device_ms_per_call(d, "snake_alias_kernel") == 0.012
    assert device_trace.device_ms_per_call(d, "snake_alias") == (10 + 14 + 100) / 3 / 1e3
    assert device_trace.device_total_ms(d, ("snake_alias_kernel", "sm90")) == 0.031
    assert device_trace.device_total_ms(d, ("Memcpy",)) is None
    assert device_trace.device_ms_per_call(d, "cudnn") is None
    assert device_trace.device_ms_per_call(d, "vectorized") == 0.001
    assert device_trace.kernel_base_name("sm90_xmma_gemm_f32f32") == "sm90_xmma_gemm_f32f32"
