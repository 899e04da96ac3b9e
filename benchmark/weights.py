"""Seeded random weights, made on the device in one draw and handed to both
the program and the reference as a state_dict with the reference's keys.

Every leaf is uniform: a kernel of shape [O, ...] in +-1/sqrt(numel / O),
the fan-in of a convolution or linear layer (of a transposed convolution's
[I, O, K] too, as torch counts it); a 1-d leaf (bias, snake alpha and beta,
LayerNorm beta) in +-0.1, a LayerNorm gamma in 1 +- 0.1; weight_g is the
norm of its weight_v, so the normalised kernel starts equal to weight_v.
No leaf is zero, so that no layer is an identity at the start (a flow
coupling's `post` is, under the program's own initialiser).
"""

from __future__ import annotations

from collections import OrderedDict

import torch


def make_state_dict(shapes: "OrderedDict[str, torch.Size]", seed: int,
                    device) -> "OrderedDict[str, torch.Tensor]":
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        shape = torch.Size(shape)
        if len(shape) >= 2:
            t = part.view(shape) / (shape.numel() / shape[0]) ** 0.5
        elif name.endswith("gamma"):
            t = 1.0 + 0.1 * part.view(shape)
        else:
            t = 0.1 * part.view(shape)
        out[name] = t
    for name in out:
        if name.endswith("weight_g"):
            v = out[name[: -len("weight_g")] + "weight_v"]
            out[name] = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return out


def shapes_of(module_factory) -> "OrderedDict[str, torch.Size]":
    """The state_dict shapes of a module built on the meta device."""
    with torch.device("meta"):
        module = module_factory()
    return OrderedDict((k, v.shape) for k, v in module.state_dict().items())
