"""Shared plumbing for the sampling loops: the batch split over a
data-parallel mesh, the x_T draw, the injected noise and the hint cast.

Under a ``mesh`` (``parallel.mesh.Mesh``; the counterpart of the JAX
samplers' ``batch_sharding``) a sampler's ``shape`` is the global batch,
which must divide by the world size (``cli.sampler_mesh`` pads it), and each
rank runs its rows: x_T and every step's noise are drawn at the global shape
from the same seeded generator and sliced (injected ones are global too),
the hint features are the rank's rows, and the result is joined on every
rank by ``gather_rows``.  The samples equal one process's on the global
batch.
"""

from __future__ import annotations

import torch


def local_batch(shape: tuple[int, ...], mesh) -> int:
    """The rows of the global ``shape`` that this rank samples; raises when
    the batch does not divide by the world size."""
    if mesh is None:
        return shape[0]
    rows = mesh.rows(shape[0])
    return rows.stop - rows.start


def global_batch(rows: int, mesh) -> int:
    """The global batch of which this rank holds ``rows`` rows."""
    return rows if mesh is None else rows * mesh.world_size


def rank_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global draw (all of it without a mesh)."""
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def draw_normal(generator: torch.Generator, shape: tuple[int, ...], device: torch.device,
                mesh=None) -> torch.Tensor:
    """N(0, 1) float32 (x_T, a step's noise) of the global ``shape`` from
    ``generator`` (which must live on ``device``), this rank's rows of it."""
    return rank_rows(torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32), mesh)


def injected(x: torch.Tensor, device: torch.device, mesh=None) -> torch.Tensor:
    """An injected global draw (x_T, a step's noise) as float32 on
    ``device``, this rank's rows of it."""
    return rank_rows(x, mesh).to(device=device, dtype=torch.float32)


def gather_result(xt: torch.Tensor, traj: list, mesh):
    """(x0, stacked trajectory) of the global batch on every rank."""
    traj = torch.stack(traj)
    if mesh is None:
        return xt, traj
    from controlnet_tpu_torch.parallel.mesh import gather_rows

    return (gather_rows(xt, mesh),
            gather_rows(traj.transpose(0, 1).contiguous(), mesh).transpose(0, 1))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors in nested dicts, tuples
    and lists) and the matching leaves of the trees in ``rest``, as
    ``jax.tree.map`` maps them; a None leaf stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def cast_hint(hint, compute_dtype):
    """Cast every leaf of the hint to the model compute type (no-op when
    either is None).  A hint is a tensor (hint features), a dict of tensors
    (a conditional UNet's ``cond_input``: the text context, the mask and the
    one-hot class alike), or under guidance a (conditional, null) pair of
    either."""
    if hint is None or compute_dtype is None:
        return hint
    return tree_map(lambda h: h.to(compute_dtype), hint)


def predict_eps(eps_fn, model, xt: torch.Tensor, t_batch: torch.Tensor, hint, compute_dtype):
    """One model call of a sampling loop: x_t cast to the compute type, the
    hint passed only when there is one, epsilon returned in float32."""
    x_in = xt if compute_dtype is None else xt.to(compute_dtype)
    if hint is None:
        return eps_fn(model, x_in, t_batch).float()
    return eps_fn(model, x_in, t_batch, hint).float()
