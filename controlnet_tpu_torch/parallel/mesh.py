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

A 2-D mesh (``make_mesh(model_parallel=m)``) lays the ranks out as the JAX
mesh lays its devices, ``reshape(N // m, m)``: rank r has data index
``r // m`` and model index ``r % m``.  The batch is split over the data axis
only (``rows``; the ``m`` ranks of a model group hold the same rows) and the
gradient and batch collectives above run over the rank's data group; the
model group is Megatron tensor parallelism's (``parallel/tp.py``).  With
``m`` 1 the data group is the default group and nothing else changes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from controlnet_tpu_torch.sample.common import tree_map


@dataclass(frozen=True)
class Mesh:
    """The process group as this rank sees it: ``world_size // model_parallel``
    data indices by ``model_parallel`` model indices.  ``data_group`` /
    ``model_group`` are this rank's groups along each axis (None: the
    default group, and no model group when ``model_parallel`` is 1)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (``n`` divisible by the
        data size): the data index's share, the same on every rank of a
        model group."""
        if n % self.data_size:
            raise ValueError(f"batch {n} is not divisible by the data size {self.data_size}")
        per = n // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)


def _axis_groups(world: int, mp: int):
    """(data group, model group) of this rank.  ``dist.new_group`` is
    collective: every rank creates every group, in the same order."""
    rank = dist.get_rank()
    data = model = None
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(world // mp)])
        if rank % mp == m:
            data = g
    for d in range(world // mp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model = g
    return data, model


def make_mesh(backend: str | None = None, device=None, model_parallel: int = 1) -> Mesh:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or take
    the group already initialised as it is.  ``device`` None is the card
    ``cuda:{LOCAL_RANK}``, made current; pass ``"cpu"`` to run on the CPU.
    The backend defaults to NCCL on a card and gloo on the CPU; a failure to
    initialise raises (nothing falls back to another backend).
    ``model_parallel`` ranks share a model group (the world size must divide
    by it); 1 is pure data parallelism over the default group."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://")
    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks are not divisible by model_parallel={model_parallel}")
    groups = _axis_groups(world, model_parallel) if model_parallel > 1 else (None, None)
    return Mesh(rank=dist.get_rank(), world_size=world, device=device,
                backend=str(dist.get_backend()), model_parallel=model_parallel,
                data_group=groups[0], model_group=groups[1])


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
    """The mean of ``flat`` over the data group, in place (a sum, then / N:
    gloo has no average)."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return flat.div_(mesh.data_size)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None, group=None) -> torch.Tensor:
    """The sum of ``x`` over the data group (or ``group``), differentiable:
    the backward sums the incoming gradients over the group, as each rank's
    input reaches every rank's output.  With every rank's loss the same
    global quantity, the averaged parameter gradient (``all_reduce_mean``) is
    then the global one.  Identity without a mesh."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.data_group if group is None else group)


@torch.no_grad()
def gather_rows(local: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global tensor whose rows ``mesh.rows`` are each data index's
    ``local``, on every rank: the rows written into zeros of the global
    shape, then one sum all-reduce over the data group (adding zeros is
    exact)."""
    if mesh is None:
        return local
    out = local.new_zeros((local.shape[0] * mesh.data_size, *local.shape[1:]))
    out[mesh.rows(out.shape[0])] = local
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return out


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (after rank 0 wrote a file the others read)."""
    if mesh is not None:
        dist.barrier()


def is_writer(mesh: Mesh | None) -> bool:
    """Only rank 0 writes checkpoints, files and logs."""
    return mesh is None or mesh.rank == 0
