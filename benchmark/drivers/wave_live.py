"""Live conversion from the wave: one `StreamingSvc` with the streaming
extractors attached, its `push_audio` calls back to back, each as soon as
the last returns: a recording replayed faster than real time.

The extractors are the configuration's (`extract`): seeded checkpoints in
the published layouts (weights_extract.py; whisper's with all its blocks
in float16) are written to a temporary directory and loaded through the
program's own loaders, so that the 32 -> 24 block cut and the float16 ->
float32 cast are the program's. The synthesizer is built and seeded as the
`live` driver builds it; the target speaker is a seeded vector.

Traffic (workload `traffic`): a recording of `recording_seconds`
(traffic/audio.py) pushed in blocks of `extract.stream.block_samples`,
replayed in a loop (the stream's state carries on); the synthesizer's
window is `block_frames` after `context_frames`, `noise_scale`;
`warm_pushes` pushes of a second stream on the same models warm the push
up, and a third stream's whisper alone every window length the timed
stream's first 15 s will meet (the program runs a window shorter than
15 s at its natural length). Correct: every push of the timed stream,
against the reference (reference/extract.py) on the same audio and
weights: the PPG frames and units it emitted (`ppg_max_abs`,
`vec_max_abs`), CREPE's probabilities of every frame it computed
(`crepe_prob_max_abs`), the count of emitted 100 fps pitch frames more
than 1 cent from the reference's fixed-lag decode (`pit_flip_frames`), and
every block against the reference's block-wise conversion of the features
it emitted (`block_max_abs`).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.compare import max_abs, tf32
from benchmark.drivers import live
from benchmark.reference import extract as rx
from benchmark.reference.infer import convert_stream
from benchmark.reference.synth import SynthesizerInfer
from benchmark.traffic.audio import recording
from benchmark.traffic.features import sub_seed
from benchmark.weights import make_state_dict, shapes_of
from benchmark.weights_extract import (crepe_state_dict, hubert_state_dict,
                                       reference_whisper_state, whisper_checkpoint)
from benchmark.work_extract import crepe_flops, crepe_frames_of_push, hubert_flops, whisper_flops

FAULTS = ("ppg", "vec", "crepe", "pit", "block")  # what `plant` alters in every fault mode
DECODE_FAULTS = ("lag", "filter")  # faults in the pitch's decode or emission, for `plant`
REF_BATCH = 8  # reference windows of one length a call


def flips(got: np.ndarray, want: np.ndarray, cents: float = 1.0) -> int:
    """Frames whose F0 is more than `cents` from the reference's (a frame
    unvoiced on one side only counts; a length mismatch counts every frame
    of the longer)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return max(got.size, want.size)
    both = (got > 0) & (want > 0)
    off = np.ones(got.shape, bool)
    off[both] = np.abs(1200.0 * np.log2(got[both] / want[both])) > cents
    off[(got <= 0) & (want <= 0)] = False
    return int(off.sum())


def decode(obs: np.ndarray, heads: list[int], his: list[int], filter_frames: int = 5,
           dtype=np.float64) -> list[np.ndarray]:
    """The pitch each push emits: the reference's fixed-lag decode of `obs`
    with the trellis advanced to each push's head, then the frames up to
    its `hi` emitted."""
    pitch = rx.FixedLagPitch(filter_frames, dtype)
    out = []
    for head, hi in zip(heads, his):
        pitch.advance(obs[pitch.head + 1 : head + 1])
        out.append(pitch.emit(hi))
    return out


def late(pits: list[np.ndarray]) -> list[np.ndarray]:
    """The pushes' 100 fps pitch one 320-hop frame late (two values), the
    first frame held, in pushes of the same lengths."""
    flat = np.concatenate(pits)
    flat = np.concatenate([flat[:2], flat[:-2]])
    return np.split(flat, np.cumsum([len(p) for p in pits])[:-1])


class Driver(live.Driver):
    unit_span = "bench.push_audio"
    trace_units = 20

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.ex = self.mc["extract"]
        self.st = self.ex["stream"]
        self.block = self.st["block_samples"]
        self.emitted: list[tuple] = []      # per push: (ppg2, vec2, pit) as the extractor returned
        self.crepe_probs: list[np.ndarray] = []  # per CREPE call of the timed stream
        self._unwrap = None
        self._flops = None
        self.diag: dict = {}  # the last check's split by push (readings)
        self.fed: list[tuple] | None = None  # the features as synthesised, once `plant` alters them

    # ---------------------------------------------------------------- set-up

    def _check_constants(self, stream_extract, whisper_mod):
        st = self.st
        have = dict(hop=stream_extract.HOP, sample_rate=whisper_mod.SAMPLE_RATE,
                    whisper_window_seconds=whisper_mod.WINDOW_SECONDS)
        wrong = {k: (v, st[k]) for k, v in have.items() if v != st[k]}
        if wrong:
            raise ValueError(f"the program's stream constants differ from the configuration's "
                             f"(program, configuration): {wrong}")

    def _load_extractors(self):
        from whisper_vits_svc_tpu_torch.models import crepe, hubert, whisper

        ex, seed, dev = self.ex, self.seed, self.device
        self.ckpts = dict(whisper=whisper_checkpoint(ex["whisper"], sub_seed(seed, 21), dev),
                          hubert=hubert_state_dict(ex["hubert_layers"], sub_seed(seed, 22), dev),
                          crepe=crepe_state_dict(ex["crepe"], sub_seed(seed, 23), dev))
        with tempfile.TemporaryDirectory(prefix="bench_extract_") as tmp:
            paths = {name: os.path.join(tmp, f"{name}.pt") for name in self.ckpts}
            for name, payload in self.ckpts.items():
                torch.save(payload, paths[name])
            self.cell.mark("extractor checkpoints written")
            self.whisper = whisper.load_whisper_encoder(paths["whisper"], device=self.device)
            self.hubert = hubert.load_hubert_soft(paths["hubert"], device=self.device)
            self.crepe = crepe.load_crepe(paths["crepe"], device=self.device)

    def _stream(self, noise_seed):
        p, st = self.p, self.st
        svc = self.StreamingSvc(self.model, self.spk, self.hp, block_frames=p["block_frames"],
                                context_frames=p["context_frames"], noise_scale=p["noise_scale"],
                                seed=noise_seed, device=self.device)
        svc.attach_extractor(self.StreamingExtractor(
            self.whisper, self.hubert, self.crepe, block_samples=self.block,
            lag_frames=st["lag_frames"], hubert_context_seconds=st["hubert_context_seconds"],
            device=self.device))
        return svc

    def _block(self, k):
        i = k % (len(self.audio) // self.block) * self.block
        return self.audio[i : i + self.block]

    def _record_crepe(self, stream_extract):
        """Keep every CREPE probability row the program computes from now
        on, by wrapping the function its streaming CREPE calls."""
        orig = stream_extract.crepe_probabilities

        def recorded(model, frames, batch_size=512):
            probs = orig(model, frames, batch_size=batch_size)
            self.crepe_probs.append(probs)
            return probs

        stream_extract.crepe_probabilities = recorded
        self._unwrap = lambda: setattr(stream_extract, "crepe_probabilities", orig)

    def setup(self):
        from whisper_vits_svc_tpu_torch.infer import pipeline, stream_extract
        from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
        from whisper_vits_svc_tpu_torch.models import whisper as whisper_mod
        from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

        self._check_constants(stream_extract, whisper_mod)
        self.StreamingSvc = StreamingSvc
        self.StreamingExtractor = stream_extract.StreamingExtractor
        self.hp = config_from_dict(self.mc)
        self.model = pipeline.build_infer_model(self.hp, device=self.device)
        self.sd = make_state_dict(shapes_of(lambda: SynthesizerInfer(self.mc)),
                                  sub_seed(self.seed, 0), self.device)
        self.model.load_state_dict(self.sd)
        self.cell.mark("program and weights")
        self._load_extractors()
        self.cell.mark("extractors loaded")
        self.audio = recording(self.p, self.seed, self.device)
        spk_dim = self.mc["vits"]["spk_dim"]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 2))
        self.spk = (torch.randn(spk_dim, generator=gen, device=self.device)
                    * spk_dim**-0.5).cpu().numpy()
        self.cell.mark("traffic")
        warm = self._stream(sub_seed(self.seed, 99))
        for k in range(self.p["warm_pushes"]):
            warm.push_audio(self._block(k))
        whisper = stream_extract.StreamingWhisper(self.whisper, device=self.device)
        for k in range(rx.WINDOW_SAMPLES // self.block):
            whisper.push(self._block(k))
        self._record_crepe(stream_extract)
        self.noise_seed = sub_seed(self.seed, 3)
        self.svc = self._stream(self.noise_seed)
        push = self.svc.extractor.push

        def recorded(samples):
            out = push(samples)
            self.emitted.append(out)
            return out

        self.svc.extractor.push = recorded
        if self.device.type == "cuda":
            print(f"wave-live resident after set-up {torch.cuda.memory_allocated()!r} bytes",
                  file=sys.stderr)

    # ---------------------------------------------------------------- the window

    def unit(self) -> dict:
        k = self.count
        self.count += 1
        x = self._block(k)
        with torch.profiler.record_function(self.unit_span):
            t0 = time.perf_counter()
            out = self.svc.push_audio(x)
            t1 = time.perf_counter()
        self.outputs.append(out)
        return dict(t0=t0, t1=t1, k=k)

    def work(self, records) -> dict:
        """The synthesis as `live` counts it, plus a push's front end:
        whisper on the push's window (15 s once the stream is that long),
        HuBERT on the whole [context | block] window the program runs, CREPE
        on the frames the push completes."""
        out = super().work(records)
        ex, block = self.ex, self.block
        if self._flops is None:
            self._flops = ({}, hubert_flops(ex["hubert_layers"], block,
                                            self.st["hubert_context_seconds"]),
                           crepe_flops(ex["crepe"], 1))
        w, h, c = self._flops

        def whisper(k):
            n = min(rx.WINDOW_SAMPLES, (k + 1) * block)
            if n not in w:
                w[n] = whisper_flops(ex["whisper"], n)
            return w[n]

        extract = sum(whisper(r["k"]) + h + c * crepe_frames_of_push(r["k"], block)
                      for r in records)
        return out | dict(flops=out["flops"] + extract,
                          whisper_flops=whisper(rx.WINDOW_SAMPLES // block))

    def release(self):
        if self._unwrap is not None:
            self._unwrap()
        del self.whisper, self.hubert, self.crepe
        super().release()

    # ---------------------------------------------------------------- the reference

    def _windows(self, stream: torch.Tensor, bounds: list[tuple[int, int]], fn) -> list:
        """fn over the windows stream[a:b], REF_BATCH windows of one length a
        call; the outputs in the order of `bounds`."""
        out = [None] * len(bounds)
        by_len: dict[int, list[int]] = {}
        for i, (a, b) in enumerate(bounds):
            by_len.setdefault(b - a, []).append(i)
        for idx in by_len.values():
            for j in range(0, len(idx), REF_BATCH):
                part = idx[j : j + REF_BATCH]
                y = fn(torch.stack([stream[bounds[i][0] : bounds[i][1]] for i in part]))
                for i, row in zip(part, y):
                    out[i] = row
        return out

    def _reference_ppg(self, stream, pushed, los, his) -> list[np.ndarray]:
        """The reference's PPG frames [lo, hi) of the windows ending at each
        of `pushed`."""
        enc = rx.whisper_encoder(self.ex["whisper"]).to(self.device).eval()
        enc.load_state_dict(reference_whisper_state(self.ckpts["whisper"]))
        bounds = [rx.whisper_window(t) for t in pushed]
        rows = self._windows(stream, bounds, lambda w: rx.ppg(enc, w))
        return [r[lo - a // rx.HOP : hi - a // rx.HOP].cpu().numpy()
                for r, (a, _), lo, hi in zip(rows, bounds, los, his)]

    def reference_features(self, n: int, control: bool = False) -> dict:
        """The reference's PPG and units of every push's emitted frames (320
        hop), CREPE's probabilities of frames 0 .. head, and the pitch each
        push emits, for the first n pushes of the timed stream."""
        ex, st, block, dev = self.ex, self.st, self.block, self.device
        reps = -(-n * block // len(self.audio))
        stream = torch.from_numpy(np.tile(self.audio, reps)[: n * block]).to(dev)
        pushed = [(k + 1) * block for k in range(n)]
        his = [t // rx.HOP - st["lag_frames"] for t in pushed]
        los = [0] + his[:-1]
        out = {}
        with tf32(control), torch.inference_mode():
            out["ppg"] = self._reference_ppg(stream, pushed, los, his)
            hub = rx.HubertSoft(ex["hubert_layers"]).to(dev).eval()
            hub.load_state_dict(self.ckpts["hubert"])
            bounds = [rx.hubert_window(t, block, st["hubert_context_seconds"]) for t in pushed]
            rows = self._windows(stream, bounds, hub.units)
            out["vec"] = [r[lo - a // rx.HOP : hi - a // rx.HOP].cpu().numpy()
                          for r, (a, _), lo, hi in zip(rows, bounds, los, his)]
            del hub, rows
            cre = rx.Crepe(ex["crepe"]).to(dev).eval()
            cre.load_state_dict(self.ckpts["crepe"])
            heads = [rx.crepe_head(t) for t in pushed]
            probs = rx.crepe_probabilities(cre, rx.crepe_frames(stream, range(heads[-1] + 1)))
            del cre
        out["probs"] = probs.cpu().numpy()
        out["pit"] = decode(rx.observations(probs), heads, his)
        return out

    def program_features(self) -> dict:
        """What the timed stream emitted and computed, in reference_features'
        layout (the PPG and units at their 320 hop)."""
        return dict(ppg=[e[0][::2] for e in self.emitted], vec=[e[1][::2] for e in self.emitted],
                    probs=(np.concatenate(self.crepe_probs) if self.crepe_probs
                           else np.zeros((0, rx.PITCH_BINS), np.float32)),
                    pit=[e[2] for e in self.emitted])

    def _blocks_reference(self, n: int, control: bool = False) -> list[np.ndarray]:
        """The reference's conversion of every push's emitted features, each
        push's padded to the block as the program pads it."""
        p, b = self.p, self.p["block_frames"]

        def padded(i):
            return np.concatenate([np.pad(e[i], [(0, b - len(e[i]))] + [(0, 0)] * (e[i].ndim - 1))
                                   for e in (self.fed or self.emitted)[:n]])

        ref = SynthesizerInfer(self.mc).to(self.device).eval()
        ref.load_state_dict(self.sd)
        with tf32(control):
            return convert_stream(ref, self.spk, padded(0), padded(1), padded(2), n,
                                  self.noise_seed, self.device, b, p["context_frames"],
                                  p["noise_scale"])

    def readings(self, mode: str) -> dict:
        """What `benchmark/readings.py` keeps beside the checks: the last
        check's split by push."""
        return dict(self.diag)

    def plant(self, kind: str) -> None:
        """Alter what the timed stream produced, as a fault would (`FAULTS`):
        a PPG frame or a unit frame replaced by its neighbour, one frame's
        CREPE probabilities moved by a bin, one emitted pitch frame moved
        by a bin (20 cents), one output sample moved by 1e-3. Or a fault in
        the pitch's decode or emission, put in the place of every push's
        pitch (`DECODE_FAULTS`): "lag", the emitted pitch one frame late
        (the emission pointer off by one); "filter", the decode of the
        program's own CREPE probabilities with the mean-5 filter left out.
        The blocks' reference keeps the features the synthesizer was fed."""
        if self.fed is None:
            self.fed = list(self.emitted)
        if kind in DECODE_FAULTS:
            if kind == "lag":
                pit = late([e[2] for e in self.emitted])
            else:
                pushed = [(k + 1) * self.block for k in range(len(self.emitted))]
                pit = decode(rx.observations(torch.from_numpy(np.concatenate(self.crepe_probs))),
                             [rx.crepe_head(t) for t in pushed],
                             [t // rx.HOP - self.st["lag_frames"] for t in pushed],
                             filter_frames=1)
            self.emitted = [(e[0], e[1], q) for e, q in zip(self.emitted, pit)]
            return
        rng = np.random.default_rng(sub_seed(self.seed, 13, FAULTS.index(kind)))
        k = int(rng.integers(len(self.emitted)))
        ppg2, vec2, pit = self.emitted[k]
        if kind in ("ppg", "vec"):
            a = (ppg2 if kind == "ppg" else vec2).copy()
            a[0:2] = a[2:4]
            self.emitted[k] = (a, vec2, pit) if kind == "ppg" else (ppg2, a, pit)
        elif kind == "pit":
            pit = pit.copy()
            pit[int(rng.integers(len(pit)))] *= 2.0 ** (20.0 / 1200.0)
            self.emitted[k] = (ppg2, vec2, pit)
        elif kind == "crepe":
            c = int(rng.integers(len(self.crepe_probs)))
            self.crepe_probs[c] = self.crepe_probs[c].copy()
            self.crepe_probs[c][0] = np.roll(self.crepe_probs[c][0], 1)
        else:
            self.outputs[k] = self.outputs[k].copy()
            self.outputs[k][int(rng.integers(len(self.outputs[k])))] += 1e-3

    def check(self, records, mode: str = "program") -> list[tuple[str, float, float]]:
        """mode "control": the reference in TF32 put in the program's place;
        a kind of FAULTS or DECODE_FAULTS plants that fault first, and any
        other mode but "program" every fault of FAULTS."""
        if mode in FAULTS + DECODE_FAULTS:
            self.plant(mode)
        elif mode not in ("program", "control"):
            for kind in FAULTS:
                self.plant(kind)
        n = len(self.outputs)
        assert len(self.emitted) == n, (len(self.emitted), n)
        ref = self.reference_features(n)
        got = self.reference_features(n, control=True) if mode == "control" \
            else self.program_features()
        ppg = [max_abs(a, r) for a, r in zip(got["ppg"], ref["ppg"])]
        vec = [max_abs(a, r) for a, r in zip(got["vec"], ref["vec"])]
        fill = rx.WINDOW_SAMPLES // self.block
        pit = flips(np.concatenate(got["pit"]), np.concatenate(ref["pit"]))
        self.diag = dict(pushes=n, ppg_fill=max(ppg[:fill]), ppg_full=max(ppg[fill:], default=0.0),
                         ppg_worst_push=int(np.argmax(ppg)), vec_fill=max(vec[:fill]),
                         vec_full=max(vec[fill:], default=0.0), crepe_frames=len(got["probs"]),
                         pit_frames=int(sum(len(x) for x in got["pit"])))
        print(f"wave-live check (pushes 0-{fill - 1} fill whisper's window): {self.diag}",
              file=sys.stderr)
        blocks_ref = self._blocks_reference(n)
        blocks = self._blocks_reference(n, control=True) if mode == "control" else self.outputs
        block = max(max_abs(a, r[: len(a)]) for a, r in zip(blocks, blocks_ref))
        lim = self.cell.limits
        return [("ppg_max_abs", max(ppg), lim["ppg_max_abs"]),
                ("vec_max_abs", max(vec), lim["vec_max_abs"]),
                ("crepe_prob_max_abs", max_abs(got["probs"], ref["probs"]),
                 lim["crepe_prob_max_abs"]),
                ("pit_flip_frames", pit, lim["pit_flip_frames"]),
                ("block_max_abs", block, lim["block_max_abs"])]
