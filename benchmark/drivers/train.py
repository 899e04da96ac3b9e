"""The GAN training step, called back to back on a pool of synthetic batches
(the data layer, disk and prefetch, left out).

Set-up builds the program's step (`init_train_states`, `make_train_step`)
with the benchmark's weights and warms every batch shape of the pool through
the step's own call, to a whole number of accumulation cycles. It then puts
the seeded weights back into the same models and zeroes both AdamW states in
place, and drives that same object through its first `checked_steps` steps
on the pool's first batches (every row different). It keeps their losses,
the first gradient as AdamW holds it after its first update (G: the mean of
the first accum_step calls' gradients; D: the first call's) and the change
of every leaf over those steps; the window goes on with that same object.
Traffic (workload `traffic`): utterances, min_frames, max_frames,
bucket_frames (traffic/features.py batch_plan), batches of the
configuration's batch_size. Correct: the reference's steps from the same
weights, batches and draws, compared by compare.py.
"""

from __future__ import annotations

import sys
import time
from fractions import Fraction

import numpy as np

import torch

from benchmark.compare import counted, leaf_gaps, rel_gap, tf32, worst_and_median
from benchmark.reference.disc import Discriminator
from benchmark.reference.step import TrainStep, losses
from benchmark.reference.synth import SynthesizerTrn
from benchmark.traffic.features import sub_seed, train_pool
from benchmark.weights import make_state_dict, shapes_of
from benchmark.work import count_flops, stage_shapes


def quadratic(counts: dict, t: int) -> int:
    """A step's FLOPs at t frames from its counts at up to three lengths:
    exactly quadratic in t (the attention's score and value products), the
    rest linear or fixed (the generator and D see one segment)."""
    if t in counts:
        return counts[t]
    pts = sorted(counts.items())
    total = Fraction(0)
    for i, (ti, fi) in enumerate(pts):
        w = Fraction(fi)
        for j, (tj, _) in enumerate(pts):
            if j != i:
                w *= Fraction(t - tj, ti - tj)
        total += w
    return round(total)


def _norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().double())) for k, t in named}


class Driver:
    unit_span = "bench.step"
    trace_units = 2

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mc = cell.model
        self.p = dict(cell.params, batch=self.mc["train"]["batch_size"])
        self.checked = self.p["checked_steps"]

    def _generator(self):
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(sub_seed(self.seed, 5))

    def _weights(self):
        sd_g = make_state_dict(shapes_of(lambda: SynthesizerTrn(self.mc)), sub_seed(self.seed, 0),
                               self.device)
        sd_d = make_state_dict(shapes_of(lambda: Discriminator(self.mc)), sub_seed(self.seed, 1),
                               self.device)
        return sd_g, sd_d

    def setup(self):
        from whisper_vits_svc_tpu_torch.train import step
        from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

        self.hp = config_from_dict(self.mc)
        self.g_state, self.d_state = step.init_train_states(self.hp, device=self.device)
        self.sd_g, self.sd_d = self._weights()
        self.g_state.model.load_state_dict(self.sd_g)
        self.d_state.model.load_state_dict(self.sd_d)
        self.step = step.make_train_step(self.hp, self.g_state, self.d_state)
        self.cell.mark("program and weights")
        self.pool = train_pool(self.mc, self.p, self.seed, self.device)
        self.cell.mark("traffic")
        self._warm()
        self.cell.mark("shapes warmed")
        self._restart()
        self.gen = self._generator()
        self.prog = self._first_steps()
        self.cell.mark("checked steps")
        self.cursor = self.checked

    def _warm(self):
        """Every batch shape of the pool once, then the last batch again until
        the accumulation cycle is whole (the program's accumulator is empty)."""
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 6))
        seen, calls, batch = set(), 0, None
        for batch in self.pool:
            if batch["ppg"].shape[1] not in seen:
                seen.add(batch["ppg"].shape[1])
                self.step(batch, gen)
                calls += 1
        while calls % self.mc["train"]["accum_step"]:
            self.step(batch, gen)
            calls += 1

    def _restart(self):
        """The seeded weights back into the same parameters, and both AdamW
        states zeroed in place: the next update is a first update again."""
        with torch.no_grad():
            for state, sd in ((self.g_state, self.sd_g), (self.d_state, self.sd_d)):
                state.model.load_state_dict(sd)
                for per_param in state.optimizer.state.values():
                    for k, v in per_param.items():
                        if torch.is_tensor(v):
                            v.zero_()
                        else:
                            per_param[k] = 0

    def _call(self, batch) -> tuple[float, float]:
        m = self.step(batch, self.gen)
        return float(m["loss_g"]), float(m["loss_d"])

    def _first_grad(self, state) -> dict:
        """exp_avg / (1 - beta1) after AdamW's first update; NaN where the
        optimizer holds no moment (it never stepped)."""
        b1 = state.optimizer.param_groups[0]["betas"][0]
        out = {}
        for n, p in state.model.named_parameters():
            m = state.optimizer.state.get(p, {}).get("exp_avg")
            out[n] = float("nan") if m is None else float(
                torch.linalg.vector_norm(m.double()) / (1 - b1))
        return out

    def _first_steps(self) -> dict:
        """The program's readings over the first steps."""
        out = dict(losses=[], grad_g=None, grad_d=None)
        k_g = self.mc["train"]["accum_step"]
        for i in range(self.checked):
            out["losses"].append(self._call(self.pool[i]))
            if i == 0:
                out["grad_d"] = self._first_grad(self.d_state)
            if i == k_g - 1:
                out["grad_g"] = self._first_grad(self.g_state)
        with torch.no_grad():
            out["delta_g"] = _norms((n, p - self.sd_g[n])
                                    for n, p in self.g_state.model.named_parameters())
            out["delta_d"] = _norms((n, p - self.sd_d[n])
                                    for n, p in self.d_state.model.named_parameters())
        return out

    def spans(self) -> dict:
        return {"bench.generator": self.g_state.model, "bench.discriminator": self.d_state.model}

    def unit(self) -> dict:
        batch = self.pool[self.cursor % len(self.pool)]
        self.cursor += 1
        with torch.profiler.record_function(self.unit_span):
            t0 = time.perf_counter()
            loss = self._call(batch)
            t1 = time.perf_counter()
        return dict(t0=t0, t1=t1, utts=batch["ppg"].shape[0], frames=batch["ppg"].shape[1],
                    loss=loss)

    def end_to_end(self, records, t0) -> dict:
        utts = sum(r["utts"] for r in records)
        ms = [float(x) for x in np.percentile([(r["t1"] - r["t0"]) * 1e3 for r in records],
                                              [0, 50, 100])]
        print(f"train steps {len(records)} ms min {ms[0]!r} median {ms[1]!r} max {ms[2]!r}",
              file=sys.stderr)
        return {"train_utt_per_s": (utts / (records[-1]["t1"] - t0), "utt/s")}

    def work(self, records) -> dict:
        per: dict[int, int] = {}
        with torch.device("meta"):
            g, d = SynthesizerTrn(self.mc), Discriminator(self.mc)

        def step(t):
            v, dt = self.mc["vits"], self.mc["data"]
            b = self.p["batch"]
            lens = torch.full((b,), t, dtype=torch.int32)
            batch = dict(ppg=torch.zeros(b, t, v["ppg_dim"]), vec=torch.zeros(b, t, v["vec_dim"]),
                         pit=torch.zeros(b, t), spk=torch.ones(b, v["spk_dim"]),
                         spec=torch.zeros(b, t, dt["filter_length"] // 2 + 1),
                         audio=torch.zeros(b, t * dt["hop_length"], 1), ppg_l=lens, spec_l=lens)
            loss_g, loss_d = losses(self.mc, g, d, batch, None)
            torch.autograd.grad(loss_d, list(d.parameters()), retain_graph=True)
            torch.autograd.grad(loss_g, list(g.parameters()))

        frames = sorted({r["frames"] for r in records})
        at = frames if len(frames) <= 3 else [frames[0], frames[len(frames) // 2], frames[-1]]
        for t in at:
            per[t] = count_flops(lambda: step(t))
        flops = sum(quadratic(per, r["frames"]) for r in records)
        return dict(flops=flops, precision=self.cell.config["precision"])

    def slice_work(self, records) -> dict:
        seg = self.mc["data"]["segment_size"] // self.mc["data"]["hop_length"]
        calls = stage_shapes(self.mc, self.p["batch"], seg) * len(records)
        return dict(snake_fwd_calls=calls, snake_bwd_calls=calls)

    def release(self):
        del self.step, self.g_state, self.d_state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str = "program") -> dict:
        """The reference's readings over the first steps; mode "control" in
        TF32, "half_batch" on the first half of each batch's rows."""
        ref = TrainStep(self.mc, self.sd_g, self.sd_d, self.device)
        half = self.p["batch"] // 2 if mode == "half_batch" else None
        gen = self._generator()
        names_g = [n for n, _ in ref.g.named_parameters()]
        names_d = [n for n, _ in ref.d.named_parameters()]
        out = dict(losses=[])
        k_g = self.mc["train"]["accum_step"]
        mean_g = None
        with tf32(mode == "control"):
            for i in range(self.checked):
                batch = self.pool[i]
                if half:
                    batch = {k: v[:half] for k, v in batch.items()}
                loss_g, loss_d, gg, dg = ref(batch, gen)
                out["losses"].append((float(loss_g), float(loss_d)))
                if i == 0:
                    out["grad_d"] = _norms(zip(names_d, dg))
                if i < k_g:  # the running mean the accumulation keeps
                    mean_g = [g.clone() for g in gg] if i == 0 else [
                        a + (g - a) / (i + 1) for a, g in zip(mean_g, gg)]
                if i == k_g - 1:
                    out["grad_g"] = _norms(zip(names_g, mean_g))
        with torch.no_grad():
            out["delta_g"] = _norms((n, p - self.sd_g[n]) for n, p in ref.g.named_parameters())
            out["delta_d"] = _norms((n, p - self.sd_d[n]) for n, p in ref.d.named_parameters())
        return out

    def check(self, records, mode: str = "program") -> list[tuple[str, float, float]]:
        """mode "control" or "half_batch": that reference in the program's
        place. The numbers: every checked step's losses (the worst relative
        gap of G's and D's over the steps), and the median leaf's gap of the
        first gradient and of the change (the worse of G's and D's medians);
        the worst leaves are in `readings`."""
        r = self.readings(mode)
        lim = self.cell.limits
        return [("loss_rel_gap", max(max(g) for g in r["losses"]), lim["loss_rel_gap"]),
                ("grad1_median_gap", max(r["grad_g"][2], r["grad_d"][2]), lim["grad1_median_gap"]),
                ("change_median_gap", max(r["change_g"][2], r["change_d"][2]),
                 lim["change_median_gap"])]

    def readings(self, mode: str = "program") -> dict:
        """Each step's relative loss gaps (G, D); for each model's first
        gradient and change the worst leaf's gap, the leaf and the median
        leaf's gap; the leaves left out by the negligible-gradient rule."""
        if getattr(self, "_readings", (None,))[0] == mode:
            return self._readings[1]
        ref = self.reference()
        got = self.prog if mode == "program" else self.reference(mode)
        out = dict(losses=[(rel_gap(a[0], b[0]), rel_gap(a[1], b[1]))
                           for a, b in zip(got["losses"], ref["losses"])])
        for m in ("g", "d"):
            leaves = counted(ref["grad_" + m])
            out["grad_" + m] = worst_and_median(leaf_gaps(got["grad_" + m], ref["grad_" + m], leaves))
            out["change_" + m] = worst_and_median(
                leaf_gaps(got["delta_" + m], ref["delta_" + m], leaves))
            out["left_out_" + m] = sorted(set(ref["grad_" + m]) - leaves)
        self._readings = (mode, out)
        return out
