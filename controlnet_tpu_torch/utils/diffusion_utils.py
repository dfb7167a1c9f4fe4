"""Classifier-free-guidance condition dropping.

Port of ``controlnet_tpu/utils/diffusion_utils.py``'s ``drop_text_condition``,
``drop_image_condition`` and ``drop_class_condition``.  The random draw comes
from an explicit ``torch.Generator``; a caller (a test) may inject the mask
instead.
"""

from __future__ import annotations

import torch


def _per_sample(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ...) broadcastable against ``like``."""
    return mask.reshape(like.shape[0], *([1] * (like.dim() - 1)))


def _keep_mask(x: torch.Tensor, drop_prob: float, generator: torch.Generator | None,
               keep: torch.Tensor | None) -> torch.Tensor:
    """(B, 1, ...) of ones (keep) and zeros (drop) in x's type: ``keep`` when
    given, else each sample dropped with probability ``drop_prob``."""
    if keep is None:
        drop = torch.rand((x.shape[0],), generator=generator, device=x.device) < drop_prob
        keep = 1.0 - drop.to(x.dtype)
    return _per_sample(keep.to(device=x.device, dtype=x.dtype), x)


def drop_text_condition(text_embed: torch.Tensor, empty_text_embed: torch.Tensor,
                        drop_prob: float, generator: torch.Generator | None = None,
                        drop: torch.Tensor | None = None) -> torch.Tensor:
    """Replace each sample's text embedding with the empty-prompt embedding
    (broadcast against ``text_embed``) with probability ``drop_prob``.
    ``drop`` (B,), true to drop, replaces the draw when given."""
    if drop_prob <= 0:
        return text_embed
    if drop is None:
        drop = torch.rand((text_embed.shape[0],), generator=generator,
                          device=text_embed.device) < drop_prob
    mask = _per_sample(drop.to(device=text_embed.device, dtype=torch.bool), text_embed)
    return torch.where(mask, empty_text_embed.to(text_embed.device), text_embed)


def drop_image_condition(image_condition: torch.Tensor, drop_prob: float,
                         generator: torch.Generator | None = None,
                         keep: torch.Tensor | None = None) -> torch.Tensor:
    """Zero each sample's conditioning image with probability ``drop_prob``.
    ``keep`` (B,), 1 to keep and 0 to drop, replaces the draw when given."""
    if drop_prob <= 0:
        return image_condition
    return image_condition * _keep_mask(image_condition, drop_prob, generator, keep)


def drop_class_condition(class_onehot: torch.Tensor, drop_prob: float,
                         generator: torch.Generator | None = None,
                         keep: torch.Tensor | None = None) -> torch.Tensor:
    """Zero each sample's one-hot class row (the null class) with
    probability ``drop_prob``.  ``keep`` as in ``drop_image_condition``."""
    if drop_prob <= 0:
        return class_onehot
    return class_onehot * _keep_mask(class_onehot, drop_prob, generator, keep)
