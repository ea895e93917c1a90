"""The data-parallel layout and the collectives of the model's code
(weakcube_tpu/parallel/mesh.py).

The JAX package shards the global batch over a 'data' mesh axis and lets
XLA insert the reductions, so its model code is that of one device. In the
port each rank is a process with B/W rows of the global batch
(parallel/distributed.py), and the code that reduces over the batch says so
itself, through this module:
  * `global_sum(x)`: x summed over the ranks, differentiable (its gradient
    is the ranks' gradients summed: every rank's loss is a share of one
    global loss); the identity at W = 1;
  * `global_rows(shape)` / `local_rows(x)`: a draw of the global batch's
    shape, and this rank's rows of it, so that the samplers draw what one
    process on the global batch draws.
These read the default process group; with none initialised W is 1.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from . import distributed


class Mesh(NamedTuple):
    """The data-parallel layout: `world` ranks, this process is `rank`."""
    world: int
    rank: int


def make_mesh(mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The layout of the initialised group (one data axis). A count in
    mesh_shape other than -1 must be the group's size."""
    world = distributed.process_count()
    shape = list(mesh_shape or [-1])
    if len(shape) != 1 or shape[0] not in (-1, world):
        raise ValueError(f"TPU.MESH_SHAPE {shape} does not describe this run's {world} "
                         "data-parallel processes")
    return Mesh(world, distributed.rank())


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) whose gradient is the all-reduced gradient: every
    rank's output feeds every rank's loss. (torch.distributed.nn.functional
    .all_reduce does the same and is deprecated from torch 2.13.)"""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return _GlobalSum.apply(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiable."""
    if distributed.process_count() == 1:
        return x
    return _GlobalSum.apply(x)


def global_rows(shape: Sequence[int]) -> tuple:
    """The global batch's shape of a per-rank (B, ...) shape (every rank
    holds B rows: the global batch divides over the ranks)."""
    return (shape[0] * distributed.process_count(), *shape[1:])


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a (W * B, ...) tensor."""
    return shard_batch(x, Mesh(distributed.process_count(), distributed.rank()))


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every array of a global batch (a dict, tuple or
    NamedTuple of numpy arrays and tensors; scalars and 0-d arrays as they
    are). The batch must divide over the ranks."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, tuple):
        rows = [shard_batch(v, mesh) for v in batch]
        return type(batch)(*rows) if hasattr(batch, "_fields") else tuple(rows)
    if getattr(batch, "ndim", 0) >= 1:
        n = batch.shape[0]
        if n % mesh.world:
            raise ValueError(f"a batch of {n} rows does not divide over {mesh.world} ranks")
        b = n // mesh.world
        return batch[mesh.rank * b:(mesh.rank + 1) * b]
    return batch


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    if mesh.world > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module
