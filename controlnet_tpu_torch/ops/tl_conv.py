"""Transposed-layout (TL) convolutions on ``(C, B, L)`` activations, L = H*W.

Port of ``controlnet_tpu/ops/tl_conv.py``: ``to_tl`` / ``from_tl``,
``conv3x3_tl`` (the hand-written CUDA kernel of ``ops/cuda_conv.py`` for CUDA
tensors, its plain version for CPU tensors), and the convolutions the JAX
package leaves to XLA einsums, which are library calls on the NCHW view here:
``conv1x1_tl`` (a ``torch.einsum``), ``conv3x3s2_tl`` and ``downconv4_tl``
(``F.conv2d`` at stride 2), ``upconvT4_tl`` (``F.conv_transpose2d``), and
``group_norm_tl``.  ``downconv4_tl``, ``upconvT4_tl`` and ``group_norm_tl``
keep JAX's contract (``_matmul_tl``): the weights rounded to the activation's
type, float32 products, sums and bias, one rounding at the end.
Weights are as the ``nn`` layers hold them: ``(Cout, Cin, kh, kw)``, and
``(Cin, Cout, 4, 4)`` for the transposed conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from controlnet_tpu_torch.ops.cuda_conv import conv3x3_tl, from_tl, to_tl

__all__ = ["to_tl", "from_tl", "conv3x3_tl", "conv1x1_tl", "conv3x3s2_tl", "downconv4_tl",
           "upconvT4_tl", "group_norm_tl"]


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


def _f32(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor):
    """The weights rounded to ``x``'s type, then they and the bias as float32."""
    return weight.to(x.dtype).float(), None if bias is None else bias.float()


def downconv4_tl(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                 hw: tuple[int, int]) -> torch.Tensor:
    """4x4 stride-2 pad-1 conv (the DownBlock downsample) -> (Cout, B,
    (H // 2) * (W // 2)), a view of the NCHW result."""
    if tuple(weight.shape[2:]) != (4, 4):
        raise ValueError(f"expected (Cout, Cin, 4, 4) weights, got {tuple(weight.shape)}")
    w32, b32 = _f32(weight, bias, x)
    return to_tl(F.conv2d(from_tl(x, hw).float(), w32, b32, stride=2, padding=1).to(x.dtype))


def upconvT4_tl(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                hw: tuple[int, int]) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) (the UpBlock 2x upsample) -> (Cout, B,
    4L) on the doubled grid, a view of the NCHW result."""
    if tuple(weight.shape[2:]) != (4, 4):
        raise ValueError(f"expected (Cin, Cout, 4, 4) weights, got {tuple(weight.shape)}")
    w32, b32 = _f32(weight, bias, x)
    out = F.conv_transpose2d(from_tl(x, hw).float(), w32, b32, stride=2, padding=1)
    return to_tl(out.to(x.dtype))


def group_norm_tl(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, num_groups: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm on (C, B, L): per sample and group, the mean and the
    (biased) variance over (C / G, L) in float32, then the float32 affine
    map, one rounding to ``x``'s type.  Contiguous (C, B, L) out."""
    c, b, l = x.shape
    xf = x.float().reshape(num_groups, c // num_groups, b, l)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(c, b, l)
    return (xf * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)
