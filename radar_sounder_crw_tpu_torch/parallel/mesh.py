"""Data parallel over a process group: the role of
radar_sounder_crw_tpu/parallel/mesh.py.

The JAX package shards the batch axis of one single-process SPMD program
over a device mesh and lets XLA insert the collectives. Its PyTorch form is
one process per device under `torch.distributed` (NCCL on the card, gloo on
the CPU): a `Mesh` is this rank's device and the group it belongs to. Each
rank takes its rows of a batch (`shard_batch`), and the trainers and the
survey issue the collectives themselves: `all_reduce_sum` (differentiable,
for BatchNorm's statistics over the ranks), `all_reduce_grads` (the
gradients and the loss in one flat buffer) and `all_gather` (the survey's
maps). `python -m torch.distributed.run --nproc_per_node N -m <entry point>`
starts the ranks; each entry point calls `init_distributed`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's device and its process group (None: one device, no
    collective; a group of one rank still issues them). `size` is the
    number of ranks, the JAX mesh's `devices.size`."""

    device: torch.device
    group: object = None
    size: int = 1
    rank: int = 0

    def shards(self, batch_size: int) -> bool:
        """Whether a batch of this size runs sharded over the ranks: there
        is a group and it divides the batch (else the batch runs whole on
        every rank)."""
        return self.group is not None and batch_size % self.size == 0


def init_distributed(device=None) -> bool:
    """Join the process group that `torch.distributed.run` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL with this rank on cuda:LOCAL_RANK, or gloo when `device` is the
    CPU. Does nothing, and returns False, when WORLD_SIZE is unset or the
    group already exists."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def make_mesh(devices=None) -> Mesh:
    """The mesh of this process.

    With a process group initialised: the whole group, this rank on
    `devices[rank]` (one device per rank) or, by default, on
    cuda:LOCAL_RANK under NCCL and on the CPU under gloo. Without one: a
    one-device mesh on `devices[0]` (the tuner pins a trial so), by default
    `resolve_device(None)`, cuda."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if devices is None:
            device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
                      if dist.get_backend() == "nccl" else torch.device("cpu"))
        elif len(devices) == size:
            device = resolve_device(devices[rank])
        else:
            raise ValueError(f"{len(devices)} devices for a process group of {size} ranks")
        return Mesh(device, dist.group.WORLD, size, rank)
    devices = [None] if devices is None else list(devices)
    if len(devices) != 1:
        raise ValueError(
            f"{len(devices)} devices without a process group: one process drives one device "
            "(start one rank a device with torch.distributed.run)"
        )
    return Mesh(resolve_device(devices[0]))


def default_mesh(device=None) -> Mesh:
    """`make_mesh()` under a process group, else a one-device mesh on
    `device`: what a trainer or a pipeline given no mesh runs on."""
    return make_mesh() if dist.is_initialized() else make_mesh([device])


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of `batch` (numpy or tensor): the rank-th of
    `mesh.size` equal slices of the leading axis. A size the mesh does not
    divide raises; callers pad or run the batch whole first."""
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch dim {n} not divisible by mesh size {mesh.size}")
    k = n // mesh.size
    return batch[mesh.rank * k : (mesh.rank + 1) * k]


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis to a multiple by repeating the last item, on
    numpy arrays and tensors alike (a tensor stays on its device). Returns
    (padded batch, number of real items)."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, b
    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, batch[-1:].expand(rem, *batch.shape[1:])]), b
    return np.concatenate([batch, np.repeat(batch[-1:], rem, axis=0)]), b


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks in the forward and in the backward: every rank's
    loss reads the sum, so the gradient of each rank's input is the sum of
    all ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (the backward is the
    same sum of the upstream gradients)."""
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_grads(params, mesh: Mesh, loss: torch.Tensor) -> torch.Tensor:
    """Sum every parameter's gradient and `loss` over the ranks in one flat
    buffer; the summed gradients replace each `.grad` (a missing one counts
    as zeros, so every rank packs the same layout). Returns the summed
    loss."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset : offset + g.numel()].view_as(g).to(g.dtype)
        offset += g.numel()
    return flat[offset]


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated along axis 0 in rank
    order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)
