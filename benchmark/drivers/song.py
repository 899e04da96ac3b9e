"""Offline conversion of whole songs through `svc_infer`, closed loop, one
request at a time, as the CLI and a batch job convert a list.

Traffic (workload `traffic`): a pool of `songs` songs whose lengths are
spread evenly over [min_frames, max_frames], cycled in a fixed order, each
request with its own noise seed; `out_chunk`, `hop_frame`, `chunk_batch`
and `noise_scale` go to svc_infer. Correct: the whole waveform of a sample
of the completed requests (the longest, and one more drawn from the seed),
against the reference's conversion of the same features and seed; only the
sample's outputs are kept.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.compare import max_abs, tf32
from benchmark.reference.infer import chunk_plan, convert_song
from benchmark.reference.layers import excitation
from benchmark.reference.synth import SynthesizerInfer
from benchmark.traffic.features import song_pool, sub_seed
from benchmark.weights import make_state_dict, shapes_of
from benchmark.work import count_flops, stage_shapes


class Driver:
    unit_span = "bench.request"
    trace_units = 1

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.p, self.mc = cell.params, cell.model
        self.count = 0
        self.outputs: dict[int, np.ndarray] = {}
        self.kept = dict(longest=None, drawn=None)
        self.rng = np.random.default_rng(sub_seed(seed, 7))

    def setup(self):
        from whisper_vits_svc_tpu_torch.infer import pipeline
        from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
        from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

        self.pipeline, self.retrieval = pipeline, DummyRetrieval()
        self.hp = config_from_dict(self.mc)
        self.model = pipeline.build_infer_model(self.hp, device=self.device)
        self.sd = make_state_dict(shapes_of(lambda: SynthesizerInfer(self.mc)),
                                  sub_seed(self.seed, 0), self.device)
        self.model.load_state_dict(self.sd)
        self.cell.mark("program and weights")
        self.songs = song_pool(self.mc, self.p, self.seed, self.device)
        self.cell.mark("traffic")
        longest = max(self.songs, key=lambda s: len(s["pit"]))
        self._convert(longest, sub_seed(self.seed, 99))

    def _convert(self, song, req_seed):
        p = self.p
        return self.pipeline.svc_infer(
            self.model, self.retrieval, song["spk"], song["pit"], song["ppg"], song["vec"],
            self.hp, noise_scale=p["noise_scale"], seed=req_seed, out_chunk=p["out_chunk"],
            hop_frame=p["hop_frame"], chunk_batch=p["chunk_batch"], device=self.device)

    def spans(self) -> dict:
        return {"bench.chunk": self.model}

    def unit(self) -> dict:
        k = self.count
        self.count += 1
        song_i = k % len(self.songs)
        req_seed = sub_seed(self.seed, 100, k)
        with torch.profiler.record_function(self.unit_span):
            t0 = time.perf_counter()
            wav = self._convert(self.songs[song_i], req_seed)
            t1 = time.perf_counter()
        frames = len(self.songs[song_i]["pit"])
        rec = dict(t0=t0, t1=t1, k=k, song=song_i, seed=req_seed, frames=frames,
                   audio_s=len(wav) / self.mc["data"]["sampling_rate"])
        self._keep(rec, wav)
        return rec

    def _keep(self, rec, wav):
        """Keep the outputs of the sample only: the longest request so far and
        one drawn uniformly from the seed among all (a reservoir of one)."""
        longest, drawn = self.kept["longest"], self.kept["drawn"]
        if longest is None or rec["frames"] > longest["frames"]:
            self.kept["longest"] = rec
        if self.rng.integers(rec["k"] + 1) == 0:
            self.kept["drawn"] = rec
        self.outputs[rec["k"]] = wav
        keep = {r["k"] for r in self.kept.values()}
        self.outputs = {k: w for k, w in self.outputs.items() if k in keep}

    def end_to_end(self, records, t0) -> dict:
        audio = sum(r["audio_s"] for r in records)
        rates = [float(x) for x in np.percentile(
            [r["audio_s"] / (r["t1"] - r["t0"]) for r in records], [0, 50, 100])]
        print(f"song requests {len(records)} audio_s/s per request min {rates[0]!r} "
              f"median {rates[1]!r} max {rates[2]!r}", file=sys.stderr)
        n = len(self.songs)
        whole = len(records) // n * n
        if whole:
            cycles = sum(r["audio_s"] for r in records[:whole]) / (records[whole - 1]["t1"] - t0)
            print(f"song whole cycles {whole // n} audio_s/s over them {cycles!r} "
                  f"requests after them {len(records) - whole}", file=sys.stderr)
        return {"song_audio_s_per_s": (audio / (records[-1]["t1"] - t0), "audio_s/s")}

    def _groups(self, frames: int) -> list[int]:
        n = len(chunk_plan(frames, self.p["out_chunk"], self.p["hop_frame"]))
        b = self.p["chunk_batch"]
        return [min(b, n - i) for i in range(0, n, b)]

    def work(self, records) -> dict:
        width = self.p["out_chunk"] + 2 * self.p["hop_frame"]
        hop = self.mc["data"]["hop_length"]
        with torch.device("meta"):
            ref = SynthesizerInfer(self.mc)
        per_batch: dict[int, int] = {}
        per_len: dict[int, int] = {}

        def chunks(b):
            v = self.mc["vits"]
            return ref(torch.zeros(b, width, v["ppg_dim"]), torch.zeros(b, width, v["vec_dim"]),
                       torch.zeros(b, width), torch.zeros(b, v["spk_dim"]),
                       torch.full((b,), width), torch.zeros(b, width * hop, 1),
                       self.p["noise_scale"], torch.zeros(b, width, v["inter_channels"]))

        def source(n):
            tp = max(1000, -(-n // 1000) * 1000)
            return excitation(torch.zeros(1, tp), hop, self.mc["data"]["sampling_rate"])

        flops = 0
        for r in records:
            n = r["frames"]
            if n not in per_len:
                per_len[n] = count_flops(lambda: source(n))
            flops += per_len[n]
            for b in self._groups(n):
                if b not in per_batch:
                    per_batch[b] = count_flops(lambda: chunks(b))
                flops += per_batch[b]
        return dict(flops=flops, precision=self.cell.config["precision"])

    def slice_work(self, records) -> dict:
        width = self.p["out_chunk"] + 2 * self.p["hop_frame"]
        calls = []
        for r in records:
            for b in self._groups(r["frames"]):
                calls += stage_shapes(self.mc, b, width)
        return dict(snake_fwd_calls=calls)

    def release(self):
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, records) -> list[dict]:
        """The longest completed request (the first of the longest) and one
        drawn uniformly from the seed among all completed."""
        return list({r["k"]: r for r in self.kept.values() if r is not None}.values())

    def reference(self, records, control: bool = False) -> dict[int, np.ndarray]:
        ref = SynthesizerInfer(self.mc).to(self.device).eval()
        ref.load_state_dict(self.sd)
        out = {}
        with tf32(control):
            for r in records:
                s = self.songs[r["song"]]
                out[r["k"]] = convert_song(ref, s["spk"], s["pit"], s["ppg"], s["vec"], r["seed"],
                                           self.device, self.p["out_chunk"], self.p["hop_frame"],
                                           self.p["noise_scale"])
        return out

    def check(self, records, mode: str = "program") -> list[tuple[str, float, float]]:
        """mode "control": the reference in TF32 put in the program's place."""
        sample = self.sample(records)
        ref = self.reference(sample)
        got = self.reference(sample, control=True) if mode == "control" else self.outputs
        gap = max(max_abs(got[r["k"]], ref[r["k"]]) for r in sample)
        return [("wave_max_abs", gap, self.cell.limits["wave_max_abs"])]
