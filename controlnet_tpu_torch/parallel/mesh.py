"""Data parallelism: one process per card, joined by ``torch.distributed``.

Port of ``controlnet_tpu/parallel/mesh.py``'s data axis.  The JAX package
shards a batch over a device mesh and lets the compiler insert the gradient
all-reduce; here each rank is a process of its own (started by ``torchrun``,
``python -m torch.distributed.run``), holds a full copy of the parameters
and takes its 1/N of the rows of every global batch, and the collectives
are explicit:

* ``all_reduce_mean`` averages one flat buffer (the step's gradients) over
  the group before any use of it;
* ``all_reduce_sum`` is a sum over the group that gradients flow through
  (its backward sums the incoming gradients), for statistics over the global
  batch (``nn.layers.BatchNorm``, the DMD feature moments);
* ``gather_rows`` gives every rank the global tensor: each rank writes its
  rows into zeros of the global shape and one sum all-reduce joins them
  (NCCL and gloo both reduce CUDA tensors; gloo has no CUDA all-gather).

With every random draw taken at the global shape and sliced, gradients
averaged and batch statistics global, a step (or a sample) at world size N
equals one process on the whole global batch, as the sharded JAX step does
by construction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from controlnet_tpu_torch.sample.common import tree_map


@dataclass(frozen=True)
class Mesh:
    """The default process group as this rank sees it."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (``n`` divisible by the
        world size)."""
        if n % self.world_size:
            raise ValueError(f"batch {n} is not divisible by the world size {self.world_size}")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(backend: str | None = None, device=None) -> Mesh:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or take
    the group already initialised as it is.  ``device`` None is the card
    ``cuda:{LOCAL_RANK}``, made current; pass ``"cpu"`` to run on the CPU.
    The backend defaults to NCCL on a card and gloo on the CPU; a failure to
    initialise raises (nothing falls back to another backend)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://")
    return Mesh(rank=dist.get_rank(), world_size=dist.get_world_size(), device=device,
                backend=str(dist.get_backend()))


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a (tree of) global batch(es): every rank holds the
    same global batch and keeps its 1/N of the leading axis."""
    return tree_map(lambda x: x[mesh.rows(x.shape[0])], batch)


# One process per card: a process's local shard is its rows of the global
# batch, so the JAX package's multi-host assembly is the same selection.
shard_host_local_batch = shard_batch


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor a module, an optimizer (``torch.optim`` or
    ``train.state.ClippedAdamW``) or a tuple of them holds."""
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, torch.optim.Optimizer):
        return [v for s in obj.state.values() for v in s.values() if torch.is_tensor(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    return [obj.exp_avg, obj.exp_avg_sq, obj.count]  # ClippedAdamW's flat moments


@torch.no_grad()
def replicate(obj, mesh: Mesh | None):
    """Broadcast every tensor ``obj`` holds (a module's parameters and
    buffers, an optimizer's moments) from rank 0, in place; returns ``obj``.
    Tensors off the mesh's device (Adam's CPU step counts, equal on every
    rank that restored the same checkpoint) are left alone under NCCL, which
    moves device tensors only."""
    if mesh is None:
        return obj
    for t in _tensors(obj):
        if mesh.backend == "nccl" and t.device.type != "cuda":
            continue
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return obj


def all_reduce_mean(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``flat`` over the group, in place (a sum, then / N: gloo
    has no average)."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return flat.div_(mesh.world_size)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the group, differentiable: the backward sums the
    incoming gradients over the group, as each rank's input reaches every
    rank's output.  With every rank's loss the same global quantity, the
    averaged parameter gradient (``all_reduce_mean``) is then the global
    one.  Identity without a mesh."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def gather_rows(local: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global tensor whose rows ``mesh.rows`` are each rank's ``local``,
    on every rank: the rows written into zeros of the global shape, then one
    sum all-reduce (adding zeros is exact)."""
    if mesh is None:
        return local
    out = local.new_zeros((local.shape[0] * mesh.world_size, *local.shape[1:]))
    out[mesh.rows(out.shape[0])] = local
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (after rank 0 wrote a file the others read)."""
    if mesh is not None:
        dist.barrier()


def is_writer(mesh: Mesh | None) -> bool:
    """Only rank 0 writes checkpoints, files and logs."""
    return mesh is None or mesh.rank == 0
