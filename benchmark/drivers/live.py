"""Live conversion: one `StreamingSvc`, its pushes back to back, each as soon
as the last returns: a recorded stream replayed faster than real time.

Traffic (workload `traffic`): a stream of `stream_blocks` blocks of
`block_frames` frames after `context_frames` of context, replayed in a loop
(the stream's state carries on), `noise_scale`; `warm_pushes` pushes of a
second stream on the same model warm it up. Correct: every block of the
timed stream, against the reference's block-wise conversion of the same
features, noise seed and carried phase.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from benchmark.compare import max_abs, tf32
from benchmark.reference.infer import convert_stream
from benchmark.reference.layers import excitation
from benchmark.reference.synth import SynthesizerInfer
from benchmark.traffic.features import stream, sub_seed
from benchmark.weights import make_state_dict, shapes_of
from benchmark.work import count_flops, stage_shapes


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else float(values[0])


class Driver:
    unit_span = "bench.push"
    trace_units = 20

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.p, self.mc = cell.params, cell.model
        self.count = 0
        self.outputs: list[np.ndarray] = []

    def _stream(self, noise_seed):
        p = self.p
        return self.StreamingSvc(self.model, self.feats["spk"], self.hp,
                                 block_frames=p["block_frames"], context_frames=p["context_frames"],
                                 noise_scale=p["noise_scale"], seed=noise_seed, device=self.device)

    def _block(self, k):
        b = self.p["block_frames"]
        i = (k % self.p["stream_blocks"]) * b
        f = self.feats
        return f["ppg"][i : i + b], f["vec"][i : i + b], f["pit"][i : i + b]

    def setup(self):
        from whisper_vits_svc_tpu_torch.infer import pipeline
        from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
        from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

        self.StreamingSvc = StreamingSvc
        self.hp = config_from_dict(self.mc)
        self.model = pipeline.build_infer_model(self.hp, device=self.device)
        self.sd = make_state_dict(shapes_of(lambda: SynthesizerInfer(self.mc)),
                                  sub_seed(self.seed, 0), self.device)
        self.model.load_state_dict(self.sd)
        self.cell.mark("program and weights")
        self.feats = stream(self.mc, self.p, self.seed, self.device)
        self.cell.mark("traffic")
        warm = self._stream(sub_seed(self.seed, 99))
        for k in range(self.p["warm_pushes"]):
            warm.push(*self._block(k))
        self.noise_seed = sub_seed(self.seed, 3)
        self.svc = self._stream(self.noise_seed)

    def spans(self) -> dict:
        return {"bench.forward": self.model}

    def unit(self) -> dict:
        k = self.count
        self.count += 1
        ppg, vec, pit = self._block(k)
        with torch.profiler.record_function(self.unit_span):
            t0 = time.perf_counter()
            out = self.svc.push(ppg, vec, pit)
            t1 = time.perf_counter()
        self.outputs.append(out)
        return dict(t0=t0, t1=t1, k=k)

    def end_to_end(self, records, t0) -> dict:
        ms = [(r["t1"] - r["t0"]) * 1e3 for r in records]
        q = [float(x) for x in np.percentile(ms, [50, 90, 99, 100])]
        print(f"live pushes {len(ms)} median_ms {q[0]!r} p90_ms {q[1]!r} p99_ms {q[2]!r} "
              f"max_ms {q[3]!r}", file=sys.stderr)
        return {"live_block_p95_ms": (p95(ms), "ms")}

    def work(self, records) -> dict:
        p, hop = self.p, self.mc["data"]["hop_length"]
        c, total, v = p["context_frames"], p["context_frames"] + p["block_frames"], self.mc["vits"]
        sr = self.mc["data"]["sampling_rate"]
        with torch.device("meta"):
            ref = SynthesizerInfer(self.mc)

        def push():
            f0 = torch.zeros(1, total)
            excitation(f0[:, c:], hop, sr, phase0=torch.zeros(1, 11), return_phase=True)
            excitation(f0[:, :c], hop, sr, phase0=torch.zeros(1, 11))
            ref(torch.zeros(1, total, v["ppg_dim"]), torch.zeros(1, total, v["vec_dim"]), f0,
                torch.zeros(1, v["spk_dim"]), torch.full((1,), total), torch.zeros(1, total * hop, 1),
                p["noise_scale"], torch.zeros(1, total, v["inter_channels"]))

        return dict(flops=count_flops(push) * len(records), precision=self.cell.config["precision"])

    def slice_work(self, records) -> dict:
        total = self.p["context_frames"] + self.p["block_frames"]
        return dict(snake_fwd_calls=stage_shapes(self.mc, 1, total) * len(records))

    def release(self):
        del self.model, self.svc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, n: int, control: bool = False) -> list[np.ndarray]:
        p, b = self.p, self.p["block_frames"]
        reps = -(-n // p["stream_blocks"])
        f = {k: np.concatenate([self.feats[k]] * reps)[: n * b] for k in ("ppg", "vec", "pit")}
        ref = SynthesizerInfer(self.mc).to(self.device).eval()
        ref.load_state_dict(self.sd)
        with tf32(control):
            return convert_stream(ref, self.feats["spk"], f["ppg"], f["vec"], f["pit"], n,
                                  self.noise_seed, self.device, b, p["context_frames"],
                                  p["noise_scale"])

    def check(self, records, mode: str = "program") -> list[tuple[str, float, float]]:
        """mode "control": the reference in TF32 put in the program's place."""
        n = len(self.outputs)
        ref = self.reference(n)
        got = self.reference(n, control=True) if mode == "control" else self.outputs
        gap = max(max_abs(a, r) for a, r in zip(got, ref))
        return [("block_max_abs", gap, self.cell.limits["block_max_abs"])]
