"""UNet blocks: Down, Mid and Up, NCHW.

Port of ``controlnet_tpu/nn/blocks.py`` (``__call__`` only).  Each block
holds its layers in the reference PyTorch grammar (``resnet_conv_first.j``
= GroupNorm, SiLU, Conv; ``t_emb_layers.j`` = SiLU, Linear;
``resnet_conv_second.j``; ``residual_input_conv.j``; ``attention_norms.j``;
``attentions.j``; with cross-attention ``cross_attention_norms.j``,
``cross_attentions.j`` and ``context_proj.j``; ``down_sample_conv`` /
``up_sample_conv``), so the reference state dict loads strictly.  The JAX
``_ResnetLayer`` and ``_AttnLayer`` (self and cross) are the functions
``_resnet_layer``, ``_attn_layer`` and ``_cross_attn_layer`` over a block's
j-th layer.

Per resnet layer:
    h = conv3x3(silu(groupnorm(x)))
    h = h + linear(silu(t_emb))            # if t_emb_dim
    h = conv3x3(silu(groupnorm(h)))
    out = h + conv1x1(x)
then optional self-attention, and cross-attention to a projected context
(the text conditioning), over the flattened H*W tokens.
"""

from __future__ import annotations

import torch
from torch import nn

from controlnet_tpu_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    Linear,
    MultiheadAttention,
    Sequential,
)


class _ResnetAttnLayers(nn.Module):
    """The layer lists shared by every block family."""

    def __init__(self, in_ch: int, out_ch: int, t_emb_dim: int | None, num_resnets: int,
                 num_attns: int, num_heads: int, norm_channels: int, num_xattns: int = 0,
                 context_dim: int | None = None):
        super().__init__()
        self.t_emb_dim = t_emb_dim
        self.cross_attn = num_xattns > 0
        if self.cross_attn and context_dim is None:
            raise ValueError("cross-attention needs a context_dim")

        def ch(i):
            return in_ch if i == 0 else out_ch

        self.resnet_conv_first = nn.ModuleList(
            Sequential(GroupNorm(norm_channels, ch(i)), nn.SiLU(), Conv2d(ch(i), out_ch, 3))
            for i in range(num_resnets))
        if t_emb_dim is not None:
            self.t_emb_layers = nn.ModuleList(
                Sequential(nn.SiLU(), Linear(t_emb_dim, out_ch)) for _ in range(num_resnets))
        self.resnet_conv_second = nn.ModuleList(
            Sequential(GroupNorm(norm_channels, out_ch), nn.SiLU(), Conv2d(out_ch, out_ch, 3))
            for _ in range(num_resnets))
        self.residual_input_conv = nn.ModuleList(
            Conv2d(ch(i), out_ch, 1) for i in range(num_resnets))
        if num_attns:
            self.attention_norms = nn.ModuleList(
                GroupNorm(norm_channels, out_ch) for _ in range(num_attns))
            self.attentions = nn.ModuleList(
                MultiheadAttention(out_ch, num_heads) for _ in range(num_attns))
        if self.cross_attn:
            self.cross_attention_norms = nn.ModuleList(
                GroupNorm(norm_channels, out_ch) for _ in range(num_xattns))
            self.cross_attentions = nn.ModuleList(
                MultiheadAttention(out_ch, num_heads) for _ in range(num_xattns))
            self.context_proj = nn.ModuleList(
                Linear(context_dim, out_ch) for _ in range(num_xattns))


def _resnet_layer(blk: _ResnetAttnLayers, j: int, x: torch.Tensor,
                  t_emb: torch.Tensor | None) -> torch.Tensor:
    h = blk.resnet_conv_first[j](x)
    if blk.t_emb_dim is not None:
        # the (f32) time-embedding term is cast to the activation type so
        # bf16 activations stay bf16
        h = h + blk.t_emb_layers[j](t_emb)[:, :, None, None].to(h.dtype)
    h = blk.resnet_conv_second[j](h)
    return h + blk.residual_input_conv[j](x)


def _attn_layer(blk: _ResnetAttnLayers, j: int, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm + self-attention over flattened tokens, residual add."""
    b, c, h, w = x.shape
    tokens = blk.attention_norms[j](x.reshape(b, c, h * w))  # (B, C, L)
    out = blk.attentions[j](tokens.transpose(1, 2))          # (B, L, C)
    return x + out.transpose(1, 2).reshape(b, c, h, w)


def _cross_attn_layer(blk: _ResnetAttnLayers, j: int, x: torch.Tensor,
                      context: torch.Tensor | None) -> torch.Tensor:
    """GroupNorm of the query tokens, attention to the projected context
    (B, L_ctx, context_dim), not normed, as keys and values; residual add."""
    if context is None:
        raise ValueError("context required for cross attention")
    b, c, h, w = x.shape
    tokens = blk.cross_attention_norms[j](x.reshape(b, c, h * w))
    kv = blk.context_proj[j](context)                                 # (B, L_ctx, C)
    out = blk.cross_attentions[j](tokens.transpose(1, 2), kv)        # (B, L, C)
    return x + out.transpose(1, 2).reshape(b, c, h, w)


class DownBlock(_ResnetAttnLayers):
    """num_layers x [resnet, (self-attn), (cross-attn)] + optional 4/2/1
    strided-conv downsample."""

    def __init__(self, in_ch: int, out_ch: int, t_emb_dim: int | None, down_sample: bool,
                 num_heads: int, num_layers: int, attn: bool, norm_channels: int,
                 cross_attn: bool = False, context_dim: int | None = None):
        super().__init__(in_ch, out_ch, t_emb_dim, num_layers, num_layers if attn else 0,
                         num_heads, norm_channels, num_layers if cross_attn else 0, context_dim)
        self.num_layers = num_layers
        self.attn = attn
        self.down_sample_conv = (Conv2d(out_ch, out_ch, 4, stride=2, padding=1)
                                 if down_sample else nn.Identity())

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor | None = None,
                context: torch.Tensor | None = None) -> torch.Tensor:
        out = x
        for i in range(self.num_layers):
            out = _resnet_layer(self, i, out, t_emb)
            if self.attn:
                out = _attn_layer(self, i, out)
            if self.cross_attn:
                out = _cross_attn_layer(self, i, out, context)
        return self.down_sample_conv(out)


class MidBlock(_ResnetAttnLayers):
    """resnet, then num_layers x [self-attn, (cross-attn), resnet]."""

    def __init__(self, in_ch: int, out_ch: int, t_emb_dim: int | None, num_heads: int,
                 num_layers: int, norm_channels: int, cross_attn: bool = False,
                 context_dim: int | None = None):
        super().__init__(in_ch, out_ch, t_emb_dim, num_layers + 1, num_layers,
                         num_heads, norm_channels, num_layers if cross_attn else 0, context_dim)
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor | None = None,
                context: torch.Tensor | None = None) -> torch.Tensor:
        out = _resnet_layer(self, 0, x, t_emb)
        for i in range(self.num_layers):
            out = _attn_layer(self, i, out)
            if self.cross_attn:
                out = _cross_attn_layer(self, i, out, context)
            out = _resnet_layer(self, i + 1, out, t_emb)
        return out


class UpBlock(_ResnetAttnLayers):
    """ConvTranspose 4/2/1 upsample + optional skip concat + num_layers x
    [resnet, (self-attn), (cross-attn)].  ``upsample_ch`` is the width of the
    pre-concat input (``in_ch // 2`` in a UNet decoder)."""

    def __init__(self, in_ch: int, out_ch: int, t_emb_dim: int | None, up_sample: bool,
                 num_heads: int, num_layers: int, attn: bool, norm_channels: int,
                 upsample_ch: int | None = None, cross_attn: bool = False,
                 context_dim: int | None = None):
        super().__init__(in_ch, out_ch, t_emb_dim, num_layers, num_layers if attn else 0,
                         num_heads, norm_channels, num_layers if cross_attn else 0, context_dim)
        self.num_layers = num_layers
        self.attn = attn
        up_ch = in_ch if upsample_ch is None else upsample_ch
        self.up_sample_conv = ConvTranspose2d(up_ch, up_ch, 4, 2, 1) if up_sample else nn.Identity()

    def forward(self, x: torch.Tensor, out_down: torch.Tensor | None = None,
                t_emb: torch.Tensor | None = None,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = self.up_sample_conv(x)
        if out_down is not None:
            x = torch.cat([x, out_down], dim=1)
        out = x
        for i in range(self.num_layers):
            out = _resnet_layer(self, i, out, t_emb)
            if self.attn:
                out = _attn_layer(self, i, out)
            if self.cross_attn:
                out = _cross_attn_layer(self, i, out, context)
        return out
