"""Transposed-layout (TL) convolutions on ``(C, B, L)`` activations, L = H*W.

Port of the parts of ``controlnet_tpu/ops/tl_conv.py`` that the LDM hint
encoder runs: ``to_tl`` / ``from_tl``, ``conv3x3_tl`` (the hand-written CUDA
kernel of ``ops/cuda_conv.py`` for CUDA tensors, its plain version for CPU
tensors), and ``conv1x1_tl`` / ``conv3x3s2_tl``, which the JAX package leaves
to XLA einsums and which are a ``torch.einsum`` and ``F.conv2d`` here.
Weights are ``(Cout, Cin, kh, kw)`` as ``nn.Conv2d`` holds them.
``downconv4_tl``, ``upconvT4_tl`` and ``group_norm_tl`` belong to the
transposed-layout UNet forward and are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from controlnet_tpu_torch.ops.cuda_conv import conv3x3_tl, from_tl, to_tl

__all__ = ["to_tl", "from_tl", "conv3x3_tl", "conv1x1_tl", "conv3x3s2_tl"]


def conv1x1_tl(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv = a channel matmul (the zero convs): float32 bias, one
    rounding to ``x``'s type."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(x.dtype)
    out = torch.einsum("oi,ibl->obl", w, x)
    if bias is not None:
        out = (out.float() + bias.float()[:, None, None]).to(x.dtype)
    return out


def conv3x3s2_tl(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                 hw: tuple[int, int]) -> torch.Tensor:
    """3x3 stride-2 pad-1 conv (the LDM hint encoder's downsample) ->
    (Cout, B, (H // 2) * (W // 2)), a view of the NCHW result."""
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"expected (Cout, Cin, 3, 3) weights, got {tuple(weight.shape)}")
    b = None if bias is None else bias.to(x.dtype)
    return to_tl(F.conv2d(from_tl(x, hw), weight.to(x.dtype), b, stride=2, padding=1))
