"""Classifier-free-guidance condition dropping.

Port of ``controlnet_tpu/utils/diffusion_utils.py``'s ``drop_image_condition``.
The random draw comes from an explicit ``torch.Generator``; a caller (a test)
may inject the keep-mask instead.
"""

from __future__ import annotations

import torch


def drop_image_condition(image_condition: torch.Tensor, drop_prob: float,
                         generator: torch.Generator | None = None,
                         keep: torch.Tensor | None = None) -> torch.Tensor:
    """Zero each sample's conditioning image with probability ``drop_prob``.
    ``keep`` (B,), 1 to keep and 0 to drop, replaces the draw when given."""
    if drop_prob <= 0:
        return image_condition
    b = image_condition.shape[0]
    if keep is None:
        drop = torch.rand((b,), generator=generator, device=image_condition.device) < drop_prob
        keep = 1.0 - drop.to(image_condition.dtype)
    keep = keep.to(device=image_condition.device, dtype=image_condition.dtype)
    return image_condition * keep.reshape(b, *([1] * (image_condition.dim() - 1)))
