"""UNet blocks: Down, Mid and Up, NCHW, with their transposed-layout and
dual-trunk forwards.

Port of ``controlnet_tpu/nn/blocks.py``.  Each block
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

Beside ``forward`` (NCHW):

* ``tl``: the same function on transposed-layout (C, B, L) activations
  (``ops/tl_conv.py``), where every stride-1 3x3 conv is kernel c; the caller
  passes the block's grid ``hw`` and tracks it.
* ``pair`` (Down and Mid): two blocks of one shape (a frozen trunk's and a
  control trunk's) advanced in lockstep, each layer's two self-attention
  cores in one call at twice the batch (``MultiheadAttention.pair``).
* ``fused`` (Down and Mid): the two blocks on their two streams joined on the
  channel axis, each conv pair as one ``groups=2`` convolution, each
  GroupNorm pair as one group norm of twice the groups, each attention pair
  as in ``pair``; with ``stop_a`` the first block's weights take no gradient
  (the frozen trunk of ``ControlNet.forward_fused``).

``pair`` and ``fused`` have no cross-attention path, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from controlnet_tpu_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    Linear,
    MultiheadAttention,
    Sequential,
    group_norm,
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


def _resnet_layer_tl(blk: _ResnetAttnLayers, j: int, x: torch.Tensor,
                     t_emb: torch.Tensor | None, hw: tuple[int, int]) -> torch.Tensor:
    h, _ = blk.resnet_conv_first[j].tl(x, hw)
    if blk.t_emb_dim is not None:
        h = h + blk.t_emb_layers[j](t_emb).T[:, :, None].to(h.dtype)
    h, _ = blk.resnet_conv_second[j].tl(h, hw)
    return h + blk.residual_input_conv[j].tl(x, hw)


def _attn_layer_tl(blk: _ResnetAttnLayers, j: int, x: torch.Tensor) -> torch.Tensor:
    """The tokens are the lane axis of (C, B, L) already: no reshapes."""
    return x + blk.attentions[j].tl(blk.attention_norms[j].tl(x))


def _cross_attn_layer_tl(blk: _ResnetAttnLayers, j: int, x: torch.Tensor,
                         context: torch.Tensor | None) -> torch.Tensor:
    if context is None:
        raise ValueError("context required for cross attention")
    kv = blk.context_proj[j](context)
    return x + blk.cross_attentions[j].tl(blk.cross_attention_norms[j].tl(x), kv)


def _layers_tl(blk, out: torch.Tensor, t_emb, context, hw: tuple[int, int]) -> torch.Tensor:
    """A Down or Up block's num_layers x [resnet, (self-attn), (cross-attn)]
    in the transposed layout."""
    for i in range(blk.num_layers):
        out = _resnet_layer_tl(blk, i, out, t_emb, hw)
        if blk.attn:
            out = _attn_layer_tl(blk, i, out)
        if blk.cross_attn:
            out = _cross_attn_layer_tl(blk, i, out, context)
    return out


def _attn_layer_pair(a: _ResnetAttnLayers, b: _ResnetAttnLayers, j: int, xa: torch.Tensor,
                     xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n, c, h, w = xa.shape
    ta = a.attention_norms[j](xa.reshape(n, c, h * w)).transpose(1, 2)
    tb = b.attention_norms[j](xb.reshape(n, c, h * w)).transpose(1, 2)
    oa, ob = a.attentions[j].pair(b.attentions[j], ta, tb)
    return (xa + oa.transpose(1, 2).reshape(n, c, h, w),
            xb + ob.transpose(1, 2).reshape(n, c, h, w))


def _refuse_cross(blk: _ResnetAttnLayers, what: str) -> None:
    if blk.cross_attn:  # not assert: must survive python -O
        raise NotImplementedError(f"{what} has no cross-attention path; use forward for "
                                  "cross-attention blocks")


def _joined(a: nn.Module, b: nn.Module, name: str, stop_a: bool) -> torch.Tensor:
    """Parameter ``name`` of ``a`` and ``b`` joined on dim 0, ``a``'s
    detached with ``stop_a``."""
    pa = getattr(a, name)
    return torch.cat([pa.detach() if stop_a else pa, getattr(b, name)])


def _conv_fused(a: Conv2d, b: Conv2d, x2: torch.Tensor, stop_a: bool) -> torch.Tensor:
    """Two convs of one shape, ``a`` on the first channel half of ``x2`` and
    ``b`` on the second, as one ``groups=2`` convolution."""
    dt = x2.dtype
    return F.conv2d(x2, _joined(a, b, "weight", stop_a).to(dt),
                    _joined(a, b, "bias", stop_a).to(dt), a.stride, a.padding, groups=2)


def _norm_fused(a: GroupNorm, b: GroupNorm, x2: torch.Tensor, stop_a: bool) -> torch.Tensor:
    """Two GroupNorms on the two channel halves as one of twice the groups."""
    return group_norm(x2, 2 * a.num_groups, _joined(a, b, "weight", stop_a),
                      _joined(a, b, "bias", stop_a), a.eps)


def _resnet_layer_fused(a: _ResnetAttnLayers, b: _ResnetAttnLayers, j: int, x2: torch.Tensor,
                        ta: torch.Tensor | None, tb: torch.Tensor | None,
                        stop_a: bool) -> torch.Tensor:
    def norm_silu_conv(sa: Sequential, sb: Sequential, x: torch.Tensor) -> torch.Tensor:
        return _conv_fused(sa[2], sb[2], F.silu(_norm_fused(sa[0], sb[0], x, stop_a)), stop_a)

    h = norm_silu_conv(a.resnet_conv_first[j], b.resnet_conv_first[j], x2)
    if a.t_emb_dim is not None:
        term_a = a.t_emb_layers[j](ta)
        term = torch.cat([term_a.detach() if stop_a else term_a, b.t_emb_layers[j](tb)], dim=1)
        h = h + term[:, :, None, None].to(h.dtype)
    h = norm_silu_conv(a.resnet_conv_second[j], b.resnet_conv_second[j], h)
    return h + _conv_fused(a.residual_input_conv[j], b.residual_input_conv[j], x2, stop_a)


def _attn_layer_fused(a: _ResnetAttnLayers, b: _ResnetAttnLayers, j: int, x2: torch.Tensor,
                      stop_a: bool) -> torch.Tensor:
    n, c2, h, w = x2.shape
    c = c2 // 2
    tokens = _norm_fused(a.attention_norms[j], b.attention_norms[j],
                         x2.reshape(n, c2, h * w), stop_a).transpose(1, 2)
    oa, ob = a.attentions[j].pair(b.attentions[j], tokens[..., :c], tokens[..., c:])
    out = torch.cat([oa.detach() if stop_a else oa, ob], dim=2)
    return x2 + out.transpose(1, 2).reshape(n, c2, h, w)


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

    def tl(self, x: torch.Tensor, t_emb: torch.Tensor | None = None,
           context: torch.Tensor | None = None, hw: tuple[int, int] | None = None) -> torch.Tensor:
        """The transposed-layout forward at grid ``hw``; a downsampling block
        leaves (hw[0] // 2, hw[1] // 2), which the caller tracks."""
        out = _layers_tl(self, x, t_emb, context, hw)
        if isinstance(self.down_sample_conv, nn.Identity):
            return out
        return self.down_sample_conv.tl(out, hw)

    def pair(self, other: DownBlock, xa: torch.Tensor, xb: torch.Tensor,
             ta: torch.Tensor | None, tb: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """This block on ``xa`` and ``other`` on ``xb`` in lockstep: resnets
        and downsample per block, each layer's two self-attention cores in one
        kernel call."""
        _refuse_cross(self, "pair()")
        oa, ob = xa, xb
        for i in range(self.num_layers):
            oa = _resnet_layer(self, i, oa, ta)
            ob = _resnet_layer(other, i, ob, tb)
            if self.attn:
                oa, ob = _attn_layer_pair(self, other, i, oa, ob)
        return self.down_sample_conv(oa), other.down_sample_conv(ob)

    def fused(self, other: DownBlock, x2: torch.Tensor, ta: torch.Tensor | None,
              tb: torch.Tensor | None, stop_a: bool = False) -> torch.Tensor:
        """This block on the first channel half of ``x2`` and ``other`` on
        the second, as one stream (module docstring)."""
        _refuse_cross(self, "fused()")
        out = x2
        for i in range(self.num_layers):
            out = _resnet_layer_fused(self, other, i, out, ta, tb, stop_a)
            if self.attn:
                out = _attn_layer_fused(self, other, i, out, stop_a)
        if isinstance(self.down_sample_conv, nn.Identity):
            return out
        return _conv_fused(self.down_sample_conv, other.down_sample_conv, out, stop_a)


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

    def tl(self, x: torch.Tensor, t_emb: torch.Tensor | None = None,
           context: torch.Tensor | None = None, hw: tuple[int, int] | None = None) -> torch.Tensor:
        out = _resnet_layer_tl(self, 0, x, t_emb, hw)
        for i in range(self.num_layers):
            out = _attn_layer_tl(self, i, out)
            if self.cross_attn:
                out = _cross_attn_layer_tl(self, i, out, context)
            out = _resnet_layer_tl(self, i + 1, out, t_emb, hw)
        return out

    def pair(self, other: MidBlock, xa: torch.Tensor, xb: torch.Tensor,
             ta: torch.Tensor | None, tb: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """As ``DownBlock.pair``."""
        _refuse_cross(self, "pair()")
        oa, ob = _resnet_layer(self, 0, xa, ta), _resnet_layer(other, 0, xb, tb)
        for i in range(self.num_layers):
            oa, ob = _attn_layer_pair(self, other, i, oa, ob)
            oa, ob = _resnet_layer(self, i + 1, oa, ta), _resnet_layer(other, i + 1, ob, tb)
        return oa, ob

    def fused(self, other: MidBlock, x2: torch.Tensor, ta: torch.Tensor | None,
              tb: torch.Tensor | None, stop_a: bool = False) -> torch.Tensor:
        """As ``DownBlock.fused``."""
        _refuse_cross(self, "fused()")
        out = _resnet_layer_fused(self, other, 0, x2, ta, tb, stop_a)
        for i in range(self.num_layers):
            out = _attn_layer_fused(self, other, i, out, stop_a)
            out = _resnet_layer_fused(self, other, i + 1, out, ta, tb, stop_a)
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

    def tl(self, x: torch.Tensor, out_down: torch.Tensor | None = None,
           t_emb: torch.Tensor | None = None, context: torch.Tensor | None = None,
           hw: tuple[int, int] | None = None) -> torch.Tensor:
        """The transposed-layout forward; ``hw`` is the grid before the
        upsample.  An upsampling block runs its layers (and the skip
        concatenation, on the channel axis 0) at the doubled grid, which the
        caller tracks."""
        if not isinstance(self.up_sample_conv, nn.Identity):
            x = self.up_sample_conv.tl(x, hw)
            hw = (hw[0] * 2, hw[1] * 2)
        if out_down is not None:
            x = torch.cat([x, out_down], dim=0)
        return _layers_tl(self, x, t_emb, context, hw)
