"""Data-parallel training over torch.distributed (the counterpart of the JAX
package's parallel/mesh.py; reference vits_extend/train.py:64-66, NCCL DDP).

One process per device: rank r trains on cuda:r (the CPU under gloo), holds
the whole model, and takes rows [r*B, (r+1)*B) of each global batch from
the rank-sharded BucketBatcher. The step computes the gradient of the
global batch's loss (train/step.py): the data-only denominators and the
partial sums that the loss needs are summed over the ranks, then the
gradients, in one all-reduce. The process group is set up from the same
`hp.dist` keys as the JAX package's (configs/base.yaml:78-85).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Rank-0 gating (the reference's `rank == 0` checks)."""
    return rank() == 0


def initialize_distributed(coordinator_address: str | None = None, num_processes: int = 1,
                           process_id: int = 0,
                           device: str | torch.device | None = "cuda") -> torch.device:
    """Joins the process group at tcp://<coordinator_address> as rank
    `process_id` of `num_processes`: NCCL when `device` is the card (rank r on
    cuda:r, modulo the cards of the host), gloo on the CPU. Without an
    address there is no group and the device is returned as asked. A group
    of one process is allowed: it runs every collective of the path.
    Idempotent: a caller that set the group up already keeps it. Returns the
    device this rank trains on."""
    dev = resolve_device(device)
    if not coordinator_address:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return dev


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def all_sum_list(tensors) -> list[torch.Tensor]:
    """Each tensor summed over the ranks, in one all-reduce of one flat
    buffer; new tensors of the same shapes."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class GlobalBatch:
    """What a loss term needs to be the global batch's: the number of ranks
    (a mean over equal local batches is the mean of the ranks' means, so a
    rank's share is its mean / world) and a detached sum over the ranks (for
    the data-only denominators and the partial sums of the terms that are
    not means of per-rank losses: the flow KL, MR-STFT spectral
    convergence)."""

    def __init__(self):
        self.world = world_size()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, detached (a new tensor)."""
        t = t.detach().clone()
        dist.all_reduce(t)
        return t
