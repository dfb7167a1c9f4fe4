"""Neural-net layers of the port.

Port of ``controlnet_tpu/nn/layers.py`` in PyTorch's idiom: ``nn.Module``s
holding their parameters under the reference PyTorch names, NCHW
activations.  As in the JAX package, a layer computes in the activation's
type (weights are cast to it), while normalization statistics and softmax
run in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from controlnet_tpu_torch.ops import attention as attention_ops
from controlnet_tpu_torch.ops import cuda_attention_proj, tl_conv


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def get_time_embedding(time_steps: torch.Tensor, temb_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: concat(sin(t/f), cos(t/f)),
    f_i = 10000^(i / (d/2)).  Scalar or (B,) timesteps -> (B, temb_dim) f32."""
    assert temb_dim % 2 == 0, "time embedding dimension must be divisible by 2"
    t = torch.atleast_1d(torch.as_tensor(time_steps)).to(torch.float32)
    half = temb_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=t.device) / half
    factor = torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=t.device), exponent)
    args = t[:, None] / factor[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _bias(b: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if b is None else b.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv2d with ``padding`` defaulting to (k-1)//2 and an optional zero
    init (the ControlNet "zero conv")."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True, zero_init: bool = False):
        pad = (kernel_size - 1) // 2 if padding is None else padding
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=pad, bias=bias)
        if zero_init:
            nn.init.zeros_(self.weight)
            if self.bias is not None:
                nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), _bias(self.bias, x.dtype),
                        self.stride, self.padding)

    def tl(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        """Transposed-layout forward on (C, B, L) activations
        (``ops/tl_conv.py``).  A stride-2 conv halves ``hw``; the caller
        keeps track of it."""
        shape = (self.kernel_size[0], self.stride[0], self.padding[0])
        if shape == (3, 1, 1):
            return tl_conv.conv3x3_tl(self.weight, self.bias, x, hw)
        if shape == (1, 1, 0):
            return tl_conv.conv1x1_tl(self.weight, self.bias, x)
        if shape == (3, 2, 1):
            return tl_conv.conv3x3s2_tl(self.weight, self.bias, x, hw)
        raise ValueError(f"no transposed-layout forward for a conv of (kernel, stride, "
                         f"padding) {shape}")


class Sequential(nn.Sequential):
    """``nn.Sequential`` (the JAX Sequential's steps are modules here:
    ``nn.SiLU`` for "silu") with a transposed-layout forward."""

    def tl(self, x: torch.Tensor, hw: tuple[int, int]) -> tuple[torch.Tensor, tuple[int, int]]:
        """Transposed-layout forward on (C, B, L) activations for chains of
        convs and activations (the hint encoders), nested or flat.  Follows
        the spatial dims through stride-2 convs; returns (out, final hw)."""
        h, w = hw
        for step in self:
            if isinstance(step, Sequential):
                x, (h, w) = step.tl(x, (h, w))
            elif isinstance(step, Conv2d):
                x = step.tl(x, (h, w))
                if step.stride[0] == 2:
                    h, w = h // 2, w // 2
            elif isinstance(step, nn.SiLU):
                x = step(x)
            else:
                raise ValueError(f"no transposed-layout forward for {type(step).__name__}")
        return x, (h, w)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1): an exact 2x spatial upsample."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _bias(self.bias, x.dtype),
                                  self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _bias(self.bias, x.dtype))


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis (dim 1) of (B, C, ...) tensors, with
    the JAX package's single-pass statistics: float32 E[x^2] - E[x]^2,
    clamped at 0.  Parameters are ``weight``/``bias`` as in ``nn.GroupNorm``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} % groups {num_groups} != 0")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        cg = c // g
        xf = x.float()
        red = tuple(range(2, x.dim()))
        n = math.prod(x.shape[2:]) * cg
        s = xf.sum(dim=red).reshape(b, g, cg).sum(-1)  # (B, G)
        ss = (xf * xf).sum(dim=red).reshape(b, g, cg).sum(-1)
        mean = s / n
        var = torch.clamp(ss / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        shape = (b, c) + (1,) * (x.dim() - 2)
        mean_c = mean.repeat_interleave(cg, dim=1).reshape(shape)
        inv_c = inv.repeat_interleave(cg, dim=1).reshape(shape)
        pshape = (1, c) + (1,) * (x.dim() - 2)
        out = (xf - mean_c) * inv_c * self.weight.reshape(pshape) + self.bias.reshape(pshape)
        return out.to(x.dtype)


class BatchNorm(nn.Module):
    """Batch norm on the batch statistics only (training mode), over the
    channel axis (dim 1): biased variance, eps 1e-5, computed in float32 and
    cast back to the input type.  No running statistics are kept: the JAX
    package's users (the DMD feature extractor, the PatchGAN discriminator)
    never run in eval mode.  Parameters are ``weight``/``bias``.

    Under a data-parallel ``mesh`` each rank holds its rows of the global
    batch and the statistics are the global batch's, as under the JAX mesh:
    two passes, as ``xf.mean`` / ``xf.var`` take them (the per-channel sum
    and count summed over the group, then the summed squared deviations from
    that mean), through ``parallel.mesh.all_reduce_sum``, which gradients
    flow through."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        if mesh is None:
            out = F.batch_norm(x.float(), None, None, self.weight, self.bias, training=True,
                               eps=self.eps)
            return out.to(x.dtype)
        from controlnet_tpu_torch.parallel.mesh import all_reduce_sum

        xf = x.float()
        red = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        count = xf.new_tensor([xf.numel() // xf.shape[1]])
        sums = all_reduce_sum(torch.cat([xf.sum(red), count]), mesh)
        mean = (sums[:-1] / sums[-1]).reshape(shape)
        d = xf - mean
        var = (all_reduce_sum((d * d).sum(red), mesh) / sums[-1]).reshape(shape)
        out = d * torch.rsqrt(var + self.eps) * self.weight.reshape(shape) + self.bias.reshape(shape)
        return out.to(x.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head self or cross attention over (B, L, C) tokens, with the
    parameters of ``nn.MultiheadAttention(embed_dim, heads)``: packed
    ``in_proj_weight`` (3D, D) / ``in_proj_bias`` and ``out_proj``.

    The projection writes q|k|v straight into the transposed (B, D, L)
    layout that the attention kernel reads; q, k and v are slices of one
    (B, 3D, L) tensor, passed on without a copy.  Cross attention takes
    ``kv_in`` of width D (the blocks project the context to D first).

    With ``fused_proj`` on (off by default; ``set_attn_fused_proj`` sets it
    below a model), a self-attention call whose shape
    ``cuda_attention_proj.fused_proj_supported`` takes runs as one kernel,
    projections included (forward only: the sampling and serving paths);
    every other call takes the split path."""

    fused_proj = False

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor | None = None) -> torch.Tensor:
        dt = q_in.dtype
        d = self.embed_dim
        w = self.in_proj_weight.to(dt)
        if (kv_in is None and self.fused_proj and cuda_attention_proj.fused_proj_supported(
                q_in.shape[1], q_in.shape[2], d, self.num_heads, dt)):
            return cuda_attention_proj.fused_attention_proj(
                q_in, w, self.in_proj_bias.to(dt), self.out_proj.weight.to(dt),
                self.out_proj.bias.to(dt), self.num_heads)
        bias = self.in_proj_bias.to(dt)[:, None]
        if kv_in is None:
            # (3D, C) @ (B, C, L) -> (B, 3D, L), contiguous
            qkv = torch.matmul(w, q_in.transpose(1, 2)) + bias
            qt, kt, vt = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        else:
            kv_t = kv_in.to(dt).transpose(1, 2)
            qt = torch.matmul(w[:d], q_in.transpose(1, 2)) + bias[:d]
            kvt = torch.matmul(w[d:], kv_t) + bias[d:]
            kt, vt = kvt[:, :d], kvt[:, d:]
        out_t = attention_ops.multi_head_attention_t(qt, kt, vt, self.num_heads)
        out = torch.matmul(self.out_proj.weight.to(dt), out_t) + self.out_proj.bias.to(dt)[:, None]
        return out.transpose(1, 2)  # (B, L, C)


def set_attn_fused_proj(module: nn.Module, on: bool) -> None:
    """Switch the fused projection + attention layer on or off for every
    ``MultiheadAttention`` below ``module``."""
    for m in module.modules():
        if isinstance(m, MultiheadAttention):
            m.fused_proj = bool(on)
