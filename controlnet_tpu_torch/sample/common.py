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
    is None)."""
    if hint is None or compute_dtype is None:
        return hint
    return hint.to(compute_dtype)
