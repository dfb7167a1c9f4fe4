"""Tensor parallelism: Megatron-style sharding over the mesh's model axis.

Port of ``controlnet_tpu/parallel/tp.py``.  The plan is the JAX package's,
leaf by leaf, keyed by the port's (reference) state-dict names:

* ResNet layer: ``conv1`` column-parallel (output channels sharded), ``t_proj``
  and ``norm2`` on the sharded channels, ``conv2`` row-parallel (input
  channels sharded, its bias replicated and added once after the sum);
  ``norm1`` and ``skip`` replicated.  Only when the hidden channel count
  divides the model axis; else the whole layer is replicated.
* Attention: the q, k and v columns sharded (the three row blocks of the
  packed ``in_proj_weight`` / ``in_proj_bias``), ``out_proj`` row-parallel
  (its input axis sharded, its bias added once).  Only when ``D`` divides.
* Any other leaf of at least 1 MiB is sharded FSDP-style along the
  trailing-most divisible axis of its JAX layout and gathered at use.

The JAX module only annotates and lets GSPMD insert the collectives; here
they are explicit, in the layers' forwards (``nn/layers.py``), which
``tp_shard_params`` marks:

* ``copy_to_model`` at the input of a column-parallel layer: identity
  forward, all-reduce over the model group backward (every rank's partial
  gradient of the replicated input);
* ``reduce_from_model`` at the output of a row-parallel layer: all-reduce
  forward, identity backward;
* ``gather_model``: all-gather forward, reduce-scatter backward, for
  sharded activations that every rank needs whole (q / k / v when the heads
  do not divide the model axis);
* ``gather_weight``: all-gather forward, the rank's slice of the gradient
  backward, for the remainder weights.  Their activations are replicated
  over the model group, so every rank computes the same whole gradient.

NCCL gathers and reduce-scatters natively (``all_gather_into_tensor``,
``reduce_scatter_tensor``); gloo, which has neither for CUDA tensors,
writes the shard into zeros and all-reduces.  Every sum of a type narrower
than float32 runs in float32, on either backend.

GroupNorm on sharded channels sums its per-group statistics over the model
group, so a group may straddle two ranks.  Attention runs on the rank's
heads through the same kernels (a / b) as without TP; JAX turns its Pallas
kernel off under TP, because GSPMD cannot partition it.  The fused
projection + attention kernel (d) computes the whole layer and cannot sit
inside a row-parallel sum: a TP attention layer with ``fused_proj`` on
raises.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

_REMAINDER_MIN_BYTES = 1 << 20

# JAX layout axis -> torch dim, by kind of leaf
_CONV = {0: 2, 1: 3, 2: 1, 3: 0}        # HWIO -> OIHW
_CONV_T = {0: 2, 1: 3, 2: 0, 3: 1}      # flipped HWIO -> (in, out, kh, kw)
_LINEAR = {0: 1, 1: 0}                  # (in, out) -> (out, in)
_RESNET = re.compile(r"^(.*)resnet_conv_first\.(\d+)\.2\.weight$")


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _layout(name: str, ndim: int) -> dict:
    if ndim == 4:
        return _CONV_T if name.endswith("up_sample_conv.weight") else _CONV
    if ndim == 2 and not name.endswith("class_emb.weight"):
        return _LINEAR
    return {a: a for a in range(ndim)}


def _remainder_dim(name: str, shape: tuple, nbytes: int, n: int) -> int | None:
    """``_remainder_spec`` of the JAX module, in torch dims."""
    if nbytes < _REMAINDER_MIN_BYTES:
        return None
    to_torch = _layout(name, len(shape))
    jax_shape = [shape[to_torch[a]] for a in range(len(shape))]
    for axis in range(len(shape) - 1, -1, -1):
        if jax_shape[axis] % n == 0 and jax_shape[axis] >= n:
            return to_torch[axis]
    return None


def _leaves(module_or_state_dict) -> dict:
    """name -> (shape, bytes) of every parameter."""
    if isinstance(module_or_state_dict, torch.nn.Module):
        items = module_or_state_dict.named_parameters()
    else:
        items = module_or_state_dict.items()
    return {k: (tuple(v.shape), v.numel() * v.element_size()) for k, v in items}


def _resnet_nodes(leaves: dict):
    """{role: parameter prefix} of every ResNet layer, by the JAX grammar's
    roles (norm1, conv1, norm2, conv2, skip, t_proj)."""
    for name in leaves:
        m = _RESNET.match(name)
        if m is None:
            continue
        base, j = m.group(1), m.group(2)
        yield {"norm1": f"{base}resnet_conv_first.{j}.0", "conv1": f"{base}resnet_conv_first.{j}.2",
               "norm2": f"{base}resnet_conv_second.{j}.0",
               "conv2": f"{base}resnet_conv_second.{j}.2",
               "skip": f"{base}residual_input_conv.{j}", "t_proj": f"{base}t_emb_layers.{j}.1"}


def tp_param_specs(module_or_state_dict, n: int) -> dict:
    """The sharded dimension of every parameter (a module's or a state
    dict's, by name) over a model axis of ``n``, or None where it is
    replicated: the JAX package's ``tp_param_specs`` with its remainder
    sharding on, leaf by leaf.  ``in_proj_weight`` / ``in_proj_bias`` are
    sharded along dim 0 block by block (q, k and v each)."""
    leaves = _leaves(module_or_state_dict)
    plan: dict = {}
    for node in _resnet_nodes(leaves):
        members = {role: [k for k in (f"{p}.weight", f"{p}.bias") if k in leaves]
                   for role, p in node.items()}
        hidden = leaves[f"{node['conv1']}.weight"][0][0]
        sharded = _div(hidden, n) and leaves[f"{node['conv2']}.weight"][0][1] == hidden
        dims = {"conv1": (0, 0), "t_proj": (0, 0), "norm2": (0, 0), "conv2": (1, None)}
        for role, keys in members.items():
            for k in keys:
                want = dims.get(role, (None, None))[0 if k.endswith("weight") else 1]
                plan[k] = want if sharded else None
    for name, (shape, _) in leaves.items():
        if not name.endswith("in_proj_weight"):
            continue
        prefix = name[:-len("in_proj_weight")]
        sharded = _div(leaves[f"{prefix}out_proj.weight"][0][0], n)
        for k, d in (("in_proj_weight", 0), ("in_proj_bias", 0), ("out_proj.weight", 1),
                     ("out_proj.bias", None)):
            plan[prefix + k] = d if sharded else None
    for name, (shape, nbytes) in leaves.items():
        if name not in plan:
            plan[name] = _remainder_dim(name, shape, nbytes, n) if n > 1 else None
    return {k: plan[k] for k in leaves}


def tp_memory_report(module_or_state_dict, n: int) -> dict:
    """Per-device parameter bytes at a model axis of ``n`` against fully
    replicated: the JAX package's ``tp_memory_report``, field by field.  A
    model built on the ``meta`` device works (nothing is allocated)."""
    leaves = _leaves(module_or_state_dict)
    plan = tp_param_specs(module_or_state_dict, n)
    total = sum(b for _, b in leaves.values())
    sharded = sum(b for k, (_, b) in leaves.items() if plan[k] is not None)
    per_device = (total - sharded) + sharded // n
    return {
        "model_axis": n,
        "total_bytes": total,
        "sharded_bytes": sharded,
        "sharded_fraction": sharded / max(total, 1),
        "per_device_bytes": per_device,
        "reduction_vs_replicated": 1.0 - per_device / max(total, 1),
    }


# ---------------------------------------------------------------------------
# collectives over the model group
# ---------------------------------------------------------------------------

# bytes this process has put through the model group's collectives (the
# tensors handed to all-reduce, all-gather and reduce-scatter); read and
# reset by callers, as the kernels' launch counters are
moved_bytes = 0


def _summed(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the model group sums it in: a type narrower than
    float32 in float32 on every backend (gloo reduces float32 and float64
    only; NCCL sums the same way, so both give the same numbers)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model group, in a new tensor (see ``_summed``)."""
    global moved_bytes
    y = _summed(x)
    y = y.clone() if y is x else y
    moved_bytes += y.numel() * y.element_size()
    dist.all_reduce(y, group=mesh.model_group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model group's shards of ``dim`` joined in model-index order.  gloo
    has no CUDA all-gather: the shard is written into zeros of the whole
    shape and summed (adding zeros is exact)."""
    global moved_bytes
    n = mesh.model_parallel
    if mesh.backend == "nccl":
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
        moved_bytes += out.numel() * out.element_size()
        dist.all_gather_into_tensor(out, xs, group=mesh.model_group)
        return out.movedim(0, dim).contiguous()  # the layout of the gloo route's
    shape = list(x.shape)
    s = shape[dim]
    shape[dim] = n * s
    out = x.new_zeros(shape)
    out.narrow(dim, mesh.model_index * s, s).copy_(x)
    return _all_reduce(out, mesh)


def _own(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    s = x.shape[dim] // mesh.model_parallel
    return x.narrow(dim, mesh.model_index * s, s)


def _reduce_scatter(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The sum over the model group, of which the rank keeps its slice of
    ``dim``."""
    global moved_bytes
    if mesh.backend == "nccl":
        xs = _summed(x.movedim(dim, 0)).contiguous()
        out = xs.new_empty((xs.shape[0] // mesh.model_parallel, *xs.shape[1:]))
        moved_bytes += xs.numel() * xs.element_size()
        dist.reduce_scatter_tensor(out, xs, group=mesh.model_group)
        return out.movedim(0, dim).to(x.dtype).contiguous()
    return _own(_all_reduce(x, mesh), dim, mesh)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.mesh), None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(w, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.mesh).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of a column-parallel layer: identity forward,
    the gradients summed over the model group backward."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The partial outputs of a row-parallel layer summed over the model
    group; the gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, mesh)


def gather_model(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """A sharded activation made whole on every rank of the model group;
    the backward sums the gradients and keeps the rank's slice."""
    return _GatherModel.apply(x, dim, mesh)


def gather_weight(w: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """A remainder-sharded weight made whole for its use; the backward keeps
    the rank's slice of the (model-group-replicated) whole gradient."""
    return _GatherWeight.apply(w, dim, mesh)


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model group, differentiable both ways (statistics
    over sharded channels: every rank's input reaches every rank's output)."""
    from controlnet_tpu_torch.parallel.mesh import all_reduce_sum

    return all_reduce_sum(x, mesh, group=mesh.model_group)


# ---------------------------------------------------------------------------
# sharding a model
# ---------------------------------------------------------------------------

def _blocks(name: str) -> int:
    """Row blocks a parameter is sharded in: q, k and v for the packed
    projection, else one."""
    return 3 if name.endswith(("in_proj_weight", "in_proj_bias")) else 1


def _narrow(t: torch.Tensor, dim: int, blocks: int, mesh) -> torch.Tensor:
    parts = t.chunk(blocks, dim)
    return torch.cat([_own(p, dim, mesh) for p in parts], dim).contiguous()


def tp_shard_params(model: torch.nn.Module, mesh) -> dict:
    """Narrow every parameter the plan shards to this rank's slice along the
    model axis, in place (the ``Parameter`` objects stay, so an optimizer
    built before or after holds the shards), and mark the layers whose
    forwards do the collectives.  Returns the plan.  Call it after the
    weights are final on every rank (loaded, ``cli.put_replicated``)."""
    from controlnet_tpu_torch.nn import layers

    n = mesh.model_parallel
    plan = tp_param_specs(model, n)
    model.tp_plan = plan
    if n == 1:
        return plan
    leaves = dict(model.named_parameters())
    grammar = set()  # the leaves of ResNet and attention nodes: never remainder-sharded
    for node in _resnet_nodes(_leaves(model)):
        grammar.update(f"{p}.{k}" for p in node.values() for k in ("weight", "bias"))
        if plan[f"{node['conv1']}.weight"] is None:
            continue
        for role, mode in (("conv1", "col"), ("t_proj", "col"), ("norm2", "shard"),
                           ("conv2", "row")):
            if f"{node[role]}.weight" in leaves:
                m = model.get_submodule(node[role])
                m.tp_mesh, m.tp_mode = mesh, mode
                if mode == "shard":
                    m.tp_channels = m.num_channels
    for name in leaves:
        if name.endswith("in_proj_weight"):
            prefix = name[:-len(".in_proj_weight")]
            if plan[name] is not None:
                model.get_submodule(prefix).tp_mesh = mesh
            grammar.update(f"{prefix}.{k}" for k in ("in_proj_weight", "in_proj_bias",
                                                     "out_proj.weight", "out_proj.bias"))
    for name, p in leaves.items():
        dim = plan[name]
        if dim is None:
            continue
        if name not in grammar:  # a remainder leaf: gathered at use
            mod, _, leaf = name.rpartition(".")
            m = model.get_submodule(mod)
            if not isinstance(m, (layers.Conv2d, layers.ConvTranspose2d, layers.Linear,
                                  layers.GroupNorm)):
                raise NotImplementedError(f"{name}: no gathered use of a {type(m).__name__}")
            m.tp_mesh = mesh
            m.tp_gather = {**(m.tp_gather or {}), leaf: dim}
        with torch.no_grad():
            p.data = _narrow(p.data, dim, _blocks(name), mesh)
        p.tp_dim = dim
    return plan


@torch.no_grad()
def tp_full_state_dict(model: torch.nn.Module, mesh, tensors: dict | None = None) -> dict:
    """The reference-format state dict of a model ``tp_shard_params`` sharded:
    every shard joined over the model group (a collective: every rank of the
    group calls it), detached, on the parameters' device.  ``tensors`` (by
    parameter name, e.g. the gradients) are joined instead of the state
    dict when given."""
    plan = getattr(model, "tp_plan", None) or {}
    out = {}
    for name, t in (model.state_dict() if tensors is None else tensors).items():
        dim = plan.get(name)
        if dim is None or mesh.model_parallel == 1:
            out[name] = t.detach().clone()
            continue
        parts = [_all_gather(p.contiguous(), dim, mesh) for p in t.chunk(_blocks(name), dim)]
        out[name] = torch.cat(parts, dim).contiguous()
    return out


__all__ = ["copy_to_model", "gather_model", "gather_weight", "model_sum", "reduce_from_model",
           "tp_full_state_dict", "tp_memory_report", "tp_param_specs", "tp_shard_params"]
