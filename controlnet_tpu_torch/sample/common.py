"""Shared plumbing for the sampling loops: the x_T draw and the hint cast."""

from __future__ import annotations

import torch


def draw_x_start(generator: torch.Generator, shape: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """x_T ~ N(0, 1) in float32, drawn from ``generator`` (which must live
    on ``device``)."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


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
