"""Random draws of the model's stochastic nodes.

`randn` and `rand` take a torch.Generator, or a `RowShard` of one: under
data parallelism each rank draws the global batch's tensor (world x its own
leading batch dimension) from the same generator and keeps its rows, so
that N ranks draw what one process draws for the concatenated batch, as the
JAX package's step draws the global batch from one key. Every draw of the
training graph has the batch first.
"""

from __future__ import annotations

import torch


class RowShard:
    """`generator` seen from rank `rank` of `world`: its draws are rows
    [rank*B, (rank+1)*B) of the global batch's."""

    def __init__(self, generator: torch.Generator | None, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world


def _draw(fn, shape, generator, device, dtype) -> torch.Tensor:
    shape = tuple(shape)
    if not isinstance(generator, RowShard):
        return fn(shape, generator=generator, device=device, dtype=dtype)
    b = shape[0]
    full = fn((b * generator.world,) + shape[1:], generator=generator.generator, device=device,
              dtype=dtype)
    return full[generator.rank * b : (generator.rank + 1) * b]


def randn(shape, generator, device=None, dtype=torch.float32) -> torch.Tensor:
    return _draw(torch.randn, shape, generator, device, dtype)


def rand(shape, generator, device=None, dtype=torch.float32) -> torch.Tensor:
    return _draw(torch.rand, shape, generator, device, dtype)
