"""Tensor-parallel rules for the Whisper content encoder over torch.distributed
(JAX whisper_vits_svc_tpu/parallel/sharding.py, on a jax.sharding mesh).

Whisper large-v2's kept encoder (24 layers, 1280 wide, ~640M parameters) is
the one model of the pipeline big enough to shard. Megatron's layout over a
model group:

  * the attention q/k/v and mlp.0 weights column-split (heads, hidden),
  * the attention out and mlp.2 weights row-split,
  * each split bias follows its weight's output dimension; a row-split
    layer's bias is added once, by the group's rank 0, before the sum,
  * the convolutions, layer norms and everything else replicated,

so a forward takes one all_reduce after each attention block and one after
each MLP. `shard_whisper_params` makes the model itself the sharded
forward: it keeps this rank's slices, sets each attention's head count to
the rank's share, and puts a `RowParallelLinear` (the all_reduce) in place
of each row-split layer, so `WhisperEncoder.forward` runs unchanged, the
key mask of padded windows included. An optional data group splits the mel
batch (the JAX mesh's `data` axis) and gathers the PPG back. One card holds
the encoder whole, so on the card this runs as a one-rank group, where each
all_reduce is a copy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.whisper import WhisperEncoder


def whisper_param_spec(name: str) -> int | None:
    """A WhisperEncoder state_dict name -> the dimension split over the
    model group (the port's Linear weights are [out, in]), or None for
    replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    if "attn" in parts:
        which = parts[-2]
        if which in ("query", "key", "value"):
            return 0
        if which == "out":
            return 1 if leaf == "weight" else None
    if "mlp" in parts:
        layer = parts[parts.index("mlp") + 1]
        if layer == "0":
            return 0
        if layer == "2":
            return 1 if leaf == "weight" else None
    return None


def tp_groups(num_data: int, num_model: int):
    """(model group, data group) of this process on a num_data x num_model
    grid of ranks (rank = d * num_model + m), as the JAX package's
    create_mesh lays its devices. Every rank creates every group."""
    assert dist.get_world_size() == num_data * num_model
    rank = dist.get_rank()
    model_groups = [dist.new_group([d * num_model + m for m in range(num_model)])
                    for d in range(num_data)]
    data_groups = [dist.new_group([d * num_model + m for d in range(num_data)])
                   for m in range(num_model)]
    return model_groups[rank // num_model], data_groups[rank % num_model]


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over `group`: this rank's
    partial product, the bias added by the group's rank 0 only, summed by
    one all_reduce. Holds `weight` [out, in / world] and `bias` [out] under
    the names of the Linear it replaces."""

    def __init__(self, linear: nn.Linear, group=None):
        super().__init__()
        self.group = group
        self.rank = dist.get_rank(group)
        self.weight = linear.weight
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias if self.rank == 0 else None)
        dist.all_reduce(y, group=self.group)
        return y


def shard_whisper_params(model: WhisperEncoder, group=None) -> WhisperEncoder:
    """Keep this rank's slice of every split parameter of `model`, give each
    attention this rank's heads, and make the row-split layers
    RowParallelLinear (in place); returns the model, whose forward is then
    the sharded one."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    assert model.blocks[0].attn.n_head % world == 0, "heads must split evenly"
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = whisper_param_spec(name)
            if dim is not None:
                assert p.shape[dim] % world == 0, (name, tuple(p.shape), world)
                p.data = p.data.chunk(world, dim)[rank].contiguous()
    for block in model.blocks:
        block.attn.n_head //= world
        block.attn.out = RowParallelLinear(block.attn.out, group)
        block.mlp[2] = RowParallelLinear(block.mlp[2], group)
    return model


def sharded_ppg_fn(model: WhisperEncoder, data_group=None):
    """-> run(mel [B, T, 80], n_frames [B] or None) -> PPG [B, T // 2,
    n_state]: the forward of a model sharded by `shard_whisper_params`. With
    `data_group`, each of its ranks takes its share of the batch rows (B a
    multiple of its size) and the PPG is gathered back whole."""

    def run(mel: torch.Tensor, n_frames: torch.Tensor | None = None) -> torch.Tensor:
        if data_group is not None:
            size, rank = dist.get_world_size(data_group), dist.get_rank(data_group)
            mel = mel.chunk(size)[rank]
            n_frames = None if n_frames is None else n_frames.chunk(size)[rank]
        with torch.no_grad():
            out = model(mel, n_frames)
        if data_group is None:
            return out
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(data_group))]
        dist.all_gather(parts, out.contiguous(), group=data_group)
        return torch.cat(parts)

    return run
