"""Classifier-free guidance at sampling time.

Port of ``controlnet_tpu/sample/cfg.py``: a wrapper that turns a conditional
``eps_fn(model, x, t, hint)`` into one with guidance, for every sampling loop of
``sample/`` (they share the eps_fn contract):

    eps = eps_uncond + s * (eps_cond - eps_uncond)

with s the guidance scale (s = 1 is the plain conditional model, s = 0 the
unconditional one).  The unconditional branch is the model on the null
condition: the zeroed hint, the null that training's condition drop uses.
"""

from __future__ import annotations

from typing import Callable

import torch

from controlnet_tpu_torch.sample.common import tree_map


def make_cfg_eps_fn(eps_fn: Callable, guidance_scale: float, batched: bool = True) -> Callable:
    """Wrap ``eps_fn`` for guidance.  The returned function has the
    signature the samplers expect, ``cfg_eps(model, x, t, hint_pair)``, with
    the hint a ``(conditional, null)`` pair of matching trees: tensors (raw
    hints or precomputed hint features) or dicts of tensors (a conditional
    UNet's ``cond_input``), concatenated leaf by leaf.

    ``batched=True`` runs both branches in one model call on a doubled batch;
    ``batched=False`` in two calls: the same math at a lower peak of
    activation memory."""
    scale = float(guidance_scale)

    def cfg_eps(model, x, t, hint_pair):
        hint_cond, hint_null = hint_pair
        if batched:
            eps2 = eps_fn(model, torch.cat([x, x]), torch.cat([t, t]),
                          tree_map(lambda c, u: torch.cat([c, u]), hint_cond, hint_null))
            eps_c, eps_u = torch.chunk(eps2, 2, dim=0)
        else:
            eps_c = eps_fn(model, x, t, hint_cond)
            eps_u = eps_fn(model, x, t, hint_null)
        return eps_u + scale * (eps_c - eps_u)

    return cfg_eps


def null_hint_features(hint_features_fn: Callable, hint: torch.Tensor) -> torch.Tensor:
    """Hint features of the all-zero (null) hint, one per sample of ``hint``
    ((B, C, H, W)).  The null hint is the same for every sample, so the hint
    encoder runs once at batch 1 and the result is expanded.  The zeros take
    the conditional hint's type and device."""
    null = torch.zeros((1, *hint.shape[1:]), dtype=hint.dtype, device=hint.device)
    feats = hint_features_fn(null)
    return feats.expand(hint.shape[0], *feats.shape[1:]).contiguous()
