"""How CREPE "full"'s forward time and memory move with the form of its
convolutions and cuDNN's algorithm choice (card only).

    python3 -m whisper_vits_svc_tpu_torch.tools.crepe_conv_probe

Seeded random weights at full width, one batch of 512 normalised frames of
a synthetic voice (the batch `crepe_probabilities` runs). Four forms of the
same function, float32 with TF32 off:
  * "conv2d": Conv2d with the reference's (K, 1) kernels on [N, C, H, 1];
  * "conv1d": the same weights as Conv1d kernels on [N, C, H];
each with cuDNN's heuristic choice and with `cudnn.benchmark` (the fastest
algorithm measured at the first call of a shape). Prints, per form, the
first call's ms (benchmark's search included), ms per call over 5 calls
(CUDA events, after 2 warm-up calls), the peak device memory of one call
above what was allocated before it, the device ms of each layer's
convolution kernels (torch.profiler, one call) and the max abs difference
from "conv2d" with the heuristic choice; then the card's name and power
limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import crepe
from ..utils.device import resolve_device


def forward(model: crepe.Crepe, frames: torch.Tensor, conv1d: bool) -> torch.Tensor:
    """Crepe.forward with the convolutions in the chosen form."""
    x = frames[:, None, :, None]
    if conv1d:
        x = x[..., 0]
    for i in range(1, 7):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        pad = (254, 254) if i == 1 else (31, 32)
        with torch.profiler.record_function(f"layer{i}"):
            if conv1d:
                x = F.relu(F.conv1d(F.pad(x, pad), conv.weight[..., 0], conv.bias,
                                    stride=conv.stride[0]))
            else:
                x = F.relu(conv(F.pad(x, (0, 0) + pad)))
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * scale
        shape = (-1, 1) if conv1d else (-1, 1, 1)
        x = x * scale.view(shape) + bias.view(shape)
        x = F.max_pool1d(x, 2, 2) if conv1d else F.max_pool2d(x, (2, 1), (2, 1))
    x = x.permute(0, 2, 1).reshape(x.shape[0], -1) if conv1d else \
        x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)
    return torch.sigmoid(model.classifier(x))


def layer_ms(fn) -> dict:
    """Device ms of the kernels under each layer's record_function range."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("layer"):
            out[e.key] = round(e.device_time_total / 1e3, 3)
    return dict(sorted(out.items()))


def main() -> None:
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
    frames = crepe.frame_audio(voice.astype(np.float32), 160)[:512]
    x = crepe.normalize_frames(torch.from_numpy(frames).to(dev))
    ref = None
    for conv1d in (False, True):
        for benchmark in (False, True):
            name = ("conv1d" if conv1d else "conv2d") + ("+benchmark" if benchmark else "")
            with torch.no_grad(), torch.backends.cudnn.flags(
                    enabled=True, benchmark=benchmark, deterministic=False, allow_tf32=False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = forward(model, x, conv1d)
                torch.cuda.synchronize()
                first_ms = 1e3 * (time.perf_counter() - t0)
                forward(model, x, conv1d)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    y = forward(model, x, conv1d)
                end.record()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                layers = layer_ms(lambda: forward(model, x, conv1d))
            if ref is None:
                ref = y
            print(json.dumps(dict(form=name, frames=len(frames), first_ms=round(first_ms, 2),
                                  ms=round(start.elapsed_time(end) / 5, 3),
                                  peak_gib=round(peak / 2**30, 3), layer_ms=layers,
                                  max_abs_err=float((y - ref).abs().max()))), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
