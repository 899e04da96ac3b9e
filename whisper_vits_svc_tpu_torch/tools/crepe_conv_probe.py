"""How CREPE "full"'s forward time and memory move with the form of its
convolutions: cuDNN's (K, 1) Conv2d and Conv1d forms, each with its
heuristic choice and with `cudnn.benchmark`, against the port's CREPE
convolution kernel (ops/crepe_conv_cuda.py), per layer and whole (card only).

    python3 -m whisper_vits_svc_tpu_torch.tools.crepe_conv_probe [--rows 64 512]

Seeded random weights at full width, batches of normalised frames of a
synthetic voice: 64 rows (the stream's static batch) and 512 (the batch
`crepe_probabilities` runs offline). Float32 with TF32 off. Prints, for
each batch, one line per layer: the kernel's ms (CUDA events over 20 calls
after 3 warm-up calls, L2 warm), the plain version's ms (cuDNN's heuristic
Conv1d and the pad, ReLU, affine and pool around it), cuDNN's Conv1d alone
with its heuristic choice and with `cudnn.benchmark` (`library_ms`), the
bound (FLOPs over 67 TFLOP/s against bytes over 3.35 TB/s: weights and
input read once, output written once), the largest |difference| from the
plain version over the largest |plain output|, and the device kernels the
plain version's convolution ran (torch.profiler, one call); then one line
per form of the whole forward: the first call's ms (benchmark's search
included), ms per call over 5 calls, the peak device memory of one call
above what was allocated before it, and the largest |difference| of the
probabilities from the plain Conv1d form; then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import crepe
from ..ops import crepe_conv_cuda as cc
from ..utils.device import resolve_device
from ..utils.profiling import start_trace, stop_trace

PEAK_FLOPS = 67e12      # H100 SXM float32 on the CUDA cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
PADS = [(254, 254)] + [(31, 32)] * 5


def forward(model: crepe.Crepe, frames: torch.Tensor, form: str) -> torch.Tensor:
    """Crepe.forward with the convolutions in the chosen form: "conv2d"
    (the reference's (K, 1) kernels on [N, C, H, 1]), "conv1d" (the plain
    version) or "kernel" (the port's kernel)."""
    if form == "kernel":
        return model(frames)
    conv1d = form == "conv1d"
    x = frames[:, None, :, None]
    if conv1d:
        x = x[..., 0]
    for i in range(1, 7):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        if conv1d:
            x = F.relu(F.conv1d(F.pad(x, PADS[i - 1]), conv.weight[..., 0], conv.bias,
                                stride=conv.stride[0]))
        else:
            x = F.relu(conv(F.pad(x, (0, 0) + PADS[i - 1])))
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * scale
        shape = (-1, 1) if conv1d else (-1, 1, 1)
        x = x * scale.view(shape) + bias.view(shape)
        x = F.max_pool1d(x, 2, 2) if conv1d else F.max_pool2d(x, (2, 1), (2, 1))
    x = x.permute(0, 2, 1).reshape(x.shape[0], -1) if conv1d else \
        x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)
    return torch.sigmoid(model.classifier(x))


def events_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device ms of fn() over `iters` calls (CUDA events), after warm-up."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> dict[str, float]:
    """{kernel name: device ms} of one call of fn (torch.profiler)."""
    prof = start_trace(cuda=True)
    fn()
    stop_trace(prof)
    return {e.key: round(e.device_time_total / 1e3, 4) for e in prof.key_averages()
            if e.device_time_total > 0 and e.key[:4] not in ("aten", "cuda")
            and e.key != "Activity Buffer Request"}


def layer_lines(model: crepe.Crepe, x: torch.Tensor) -> list[dict]:
    """One dict a layer at x's batch: the kernel, the plain version,
    cuDNN alone (heuristic, benchmark), the bound, the difference, the
    plain convolution's device kernels."""
    lines = []
    for i in range(1, 7):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        w, stride, pad = conv.weight[..., 0], conv.stride[0], PADS[i - 1]
        args = (x, w, conv.bias, scale, shift, stride, pad)
        n, ci, length = x.shape
        co, _, k = w.shape
        t = (length + sum(pad) - k) // stride + 1
        flops = 2.0 * n * co * t * ci * k
        n_bytes = 4.0 * (w.numel() + x.numel() + n * co * t // 2 + 3 * co)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            got = cc.conv_relu_affine_pool_cuda(*args)
            want = cc.conv_relu_affine_pool_plain(*args)
            kernel_ms = events_ms(lambda: cc.conv_relu_affine_pool_cuda(*args))
            plain_ms = events_ms(lambda: cc.conv_relu_affine_pool_plain(*args))
            xp = F.pad(x, pad)
            cudnn_ms = events_ms(lambda: F.conv1d(xp, w, conv.bias, stride=stride))
            kernels = device_kernels(lambda: F.conv1d(xp, w, conv.bias, stride=stride))
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                        allow_tf32=False):
            cudnn_bench_ms = events_ms(lambda: F.conv1d(xp, w, conv.bias, stride=stride))
        p = cc.plan(n, co, cc.walk(length, ci, k, stride, pad), *cc.card_slots(x.device))
        lines.append(dict(
            layer=i, rows=n, shape=[ci, co, k, stride, t], bm=p.bm, splits=p.splits,
            blocks=p.blocks, kernel_ms=round(kernel_ms, 4), plain_ms=round(plain_ms, 4),
            library_ms=dict(heuristic=round(cudnn_ms, 4), benchmark=round(cudnn_bench_ms, 4)),
            bound_ms=round(1e3 * max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES), 4),
            bound_by="flops" if flops / PEAK_FLOPS >= n_bytes / PEAK_BYTES else "bytes",
            tflops=round(flops / kernel_ms / 1e9, 2),
            max_rel_err=float((got - want).abs().max() / want.abs().max()),
            cudnn_kernels=kernels))
        x = want
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[64, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("crepe_conv_probe: needs an NVIDIA GPU")
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    model = crepe.Crepe("full").to(dev).eval()
    with torch.no_grad():
        for i in range(1, 7):
            bn = getattr(model, f"conv{i}_BN")
            bn.running_var.uniform_(0.5, 1.5)
    t = np.arange(int(5.2 * 16000)) / 16000
    voice = (0.5 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))))
    all_frames = crepe.frame_audio(voice.astype(np.float32), 160)
    for rows in args.rows:
        x = crepe.normalize_frames(torch.from_numpy(all_frames[:rows]).to(dev))
        with torch.inference_mode():
            for line in layer_lines(model, x[:, None, :]):
                print(json.dumps(line), flush=True)
            ref = None
            for form, benchmark in (("conv1d", False), ("conv1d", True), ("conv2d", False),
                                    ("conv2d", True), ("kernel", False)):
                with torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                                deterministic=False, allow_tf32=False):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = forward(model, x, form)
                    torch.cuda.synchronize()
                    first_ms = 1e3 * (time.perf_counter() - t0)
                    forward(model, x, form)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    ms = events_ms(lambda: forward(model, x, form), iters=5, warm=0)
                    peak = torch.cuda.max_memory_allocated() - base
                if ref is None:
                    ref = y
                print(json.dumps(dict(form=form + ("+benchmark" if benchmark else ""),
                                      rows=rows, first_ms=round(first_ms, 2), ms=round(ms, 3),
                                      peak_gib=round(peak / 2**30, 3),
                                      max_abs_err=float((y - ref).abs().max()))), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
