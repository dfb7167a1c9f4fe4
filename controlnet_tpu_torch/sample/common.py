"""Shared plumbing for the sampling loops: the x_T draw and the hint cast."""

from __future__ import annotations

import torch


def draw_x_start(generator: torch.Generator, shape: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """x_T ~ N(0, 1) in float32, drawn from ``generator`` (which must live
    on ``device``)."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def cast_hint(hint, compute_dtype):
    """Cast the hint (features) to the model compute type (no-op when either
    is None).  Under guidance the hint is a (conditional, null) pair: each
    member is cast."""
    if hint is None or compute_dtype is None:
        return hint
    if isinstance(hint, tuple):
        return tuple(h.to(compute_dtype) for h in hint)
    return hint.to(compute_dtype)


def predict_eps(eps_fn, model, xt: torch.Tensor, t_batch: torch.Tensor, hint, compute_dtype):
    """One model call of a sampling loop: x_t cast to the compute type, the
    hint passed only when there is one, epsilon returned in float32."""
    x_in = xt if compute_dtype is None else xt.to(compute_dtype)
    if hint is None:
        return eps_fn(model, x_in, t_batch).float()
    return eps_fn(model, x_in, t_batch, hint).float()
