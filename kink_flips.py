#!/usr/bin/env python3
"""How one ReLU-branch flip moves float32 gradients, on one NVIDIA GPU.

    python3 kink_flips.py

The discriminators are piecewise linear: a leaky-ReLU input that lies within
float32 rounding of zero can take the other branch in another summation
order, and the gradient at that element then changes by (1 - slope) times
its size, whatever the precision. This drives the period-7 MPD
(base-width channels, seeded weights) on 8 seeded random inputs, in float32
on the card and in float32 on the CPU, each against float64 on the CPU, and
prints per layer: the pre-activations' relative L2 error, how many of them
took the other branch, the relative L2 error of the gradient at each
pre-activation, and the worst parameter gradient's. It is why
chip_smoke.py's card-vs-CPU gradient check makes the CPU take the card's
branches.
"""

from __future__ import annotations

import copy
import sys

import torch
import torch.nn.functional as F

from whisper_vits_svc_tpu_torch.models.discriminator import DiscriminatorP
from whisper_vits_svc_tpu_torch.utils.device import resolve_device

PERIOD, BATCH, SAMPLES, SEEDS = 7, 4, 8000, 8


def _run(model: DiscriminatorP, x: torch.Tensor):
    """Pre-activations, then d loss / d pre-activation layer by layer
    followed by d loss / d parameter."""
    h = F.pad(x, (0, -x.shape[-1] % PERIOD), mode="reflect")
    h = h.reshape(BATCH, 1, -1, PERIOD)
    zs, fmaps = [], []
    for conv in model.convs:
        zs.append(conv(h))
        h = F.leaky_relu(zs[-1], model.lrelu_slope)
        fmaps.append(h)
    score = model.conv_post(h)
    loss = sum(torch.mean(torch.square(f)) for f in fmaps) + torch.mean(torch.square(score - 1))
    grads = torch.autograd.grad(loss, zs + list(model.parameters()))
    return [z.detach().double().cpu() for z in zs], [g.double().cpu() for g in grads]


def main() -> int:
    card = resolve_device("cuda")  # raises without CUDA; TF32 off
    model = DiscriminatorP(PERIOD)
    gen = torch.Generator().manual_seed(0)
    for conv in [*model.convs, model.conv_post]:
        conv.init_weights(gen)
    model64, model_card = copy.deepcopy(model).double(), copy.deepcopy(model).to(card)

    def rel(a, b):
        return f"{float((a - b).norm() / b.norm()):.1e}"

    for seed in range(SEEDS):
        x = torch.randn(BATCH, 1, SAMPLES, generator=torch.Generator().manual_seed(seed)) * 0.2
        ref_z, ref_g = _run(model64, x.double())
        if seed == 0:
            print(f"period-{PERIOD} MPD, pre-activations per layer "
                  f"{[z.numel() for z in ref_z]}; each side against cpu float64")
        for name, m, xx in (("cpu float32", model, x), ("cuda float32", model_card, x.to(card))):
            zs, grads = _run(m, xx)
            n = len(zs)
            flips = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(zs, ref_z)]
            worst = max((float((a - b).norm() / b.norm()), p) for (p, _), a, b in
                        zip(model.named_parameters(), grads[n:], ref_g[n:]))
            print(f"seed {seed} {name:>13}: pre-act rel L2 "
                  f"{[rel(a, b) for a, b in zip(zs, ref_z)]}, branch flips {flips}, "
                  f"d loss/d pre-act rel L2 {[rel(a, b) for a, b in zip(grads[:n], ref_g)]}, "
                  f"worst parameter gradient rel L2 {worst[0]:.1e} ({worst[1]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
