"""The UNet (epsilon prediction), NCHW, unconditioned or conditioned.

Port of ``controlnet_tpu/models/unet.py``: defaults reproduce the reference
base UNet (GroupNorm(8), attention at every level, a 16-wide last decoder
stage); a ``condition_config`` adds the reference conditional UNet's
branches (``unet_cond_base.py``), any subset of

  * class: a one-hot (B, num_classes) row times ``class_emb.weight`` added to
    the time embedding (an all-zero row is the null class);
  * text: cross-attention after every self-attention layer, to the context
    ``cond_input["text"]`` (B, L_ctx, text_embed_dim) projected per layer;
  * image: the mask ``cond_input["image"]`` (B, C_mask, H', W') resized to
    x's grid as ``jax.image.resize(..., "nearest")`` resizes it, a bias-free
    1x1 ``cond_conv_in``, concatenated to x's channels before ``conv_in``.

    conv_in -> downs (skips saved) -> mids -> ups (skip concat) ->
    norm_out -> SiLU -> conv_out

The staged methods (``time_embed``, ``stem``, ``encode``, ``mid_stage``,
``decode``) are what ControlNet composes; their conditioning arguments
default to None.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.nn.blocks import DownBlock, MidBlock, UpBlock
from controlnet_tpu_torch.nn.layers import (Conv2d, GroupNorm, Linear, Sequential,
                                            get_time_embedding, silu)


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *hw), nearest neighbour at half-pixel centres:
    output index i reads input floor((i + 0.5) * n_in / n_out), computed in
    float32 as ``jax.image.resize(..., "nearest")`` computes it (PyTorch's
    ``mode="nearest"`` reads floor(i * n_in / n_out) instead)."""
    for dim, n in zip((2, 3), hw):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n)
            x = x.index_select(dim, idx.floor().long())
    return x


class UNet(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any], use_up: bool = True):
        super().__init__()
        mp = model_config
        cfg.validate_unet_model_params(mp)
        self.im_channels = im_channels
        self.down_channels = list(mp["down_channels"])
        self.mid_channels = list(mp["mid_channels"])
        self.t_emb_dim = mp["time_emb_dim"]
        self.down_sample = list(mp["down_sample"])
        self.attns = list(mp.get("attn_down", [True] * (len(self.down_channels) - 1)))
        self.norm_channels = mp.get("norm_channels", 8)
        self.num_heads = mp.get("num_heads", 4)
        self.conv_out_channels = mp.get("conv_out_channels", 16)
        self.use_up = use_up
        if len(self.attns) != len(self.down_channels) - 1:
            raise cfg.ConfigError("len(attn_down) must be len(down_channels) - 1")

        # conditioning (unet_cond_base.py:35-76)
        self.class_cond = self.text_cond = self.image_cond = False
        self.text_embed_dim = None
        cc = cfg.get_config_value(mp, "condition_config")
        if cc is not None:
            types = cc["condition_types"]
            if "class" in types:
                cfg.validate_class_config(cc)
                self.class_cond = True
                self.num_classes = cc["class_condition_config"]["num_classes"]
            if "text" in types:
                cfg.validate_text_config(cc)
                self.text_cond = True
                self.text_embed_dim = cc["text_condition_config"]["text_embed_dim"]
            if "image" in types:
                cfg.validate_image_config(cc)
                self.image_cond = True
                icc = cc["image_condition_config"]
                self.im_cond_input_ch = icc["image_condition_input_channels"]
                self.im_cond_output_ch = icc["image_condition_output_channels"]
        self.cond = self.class_cond or self.text_cond or self.image_cond

        if self.class_cond:
            self.class_emb = nn.Embedding(self.num_classes, self.t_emb_dim)
        in_ch = im_channels
        if self.image_cond:
            self.cond_conv_in = Conv2d(self.im_cond_input_ch, self.im_cond_output_ch, 1,
                                       bias=False)
            in_ch += self.im_cond_output_ch
        self.conv_in = Conv2d(in_ch, self.down_channels[0], 3)
        self.t_proj = Sequential(Linear(self.t_emb_dim, self.t_emb_dim), nn.SiLU(),
                                 Linear(self.t_emb_dim, self.t_emb_dim))
        dc = self.down_channels
        self.downs = nn.ModuleList(
            DownBlock(dc[i], dc[i + 1], self.t_emb_dim, down_sample=self.down_sample[i],
                      num_heads=self.num_heads, num_layers=mp["num_down_layers"],
                      attn=self.attns[i], norm_channels=self.norm_channels,
                      cross_attn=self.text_cond, context_dim=self.text_embed_dim)
            for i in range(len(dc) - 1))
        mc = self.mid_channels
        self.mids = nn.ModuleList(
            MidBlock(mc[i], mc[i + 1], self.t_emb_dim, num_heads=self.num_heads,
                     num_layers=mp["num_mid_layers"], norm_channels=self.norm_channels,
                     cross_attn=self.text_cond, context_dim=self.text_embed_dim)
            for i in range(len(mc) - 1))
        if use_up:
            # i walks len(dc)-2 .. 0; the input is [upsampled || skip], both dc[i] wide
            self.ups = nn.ModuleList(
                UpBlock(dc[i] * 2, dc[i - 1] if i != 0 else self.conv_out_channels,
                        self.t_emb_dim, up_sample=self.down_sample[i], num_heads=self.num_heads,
                        num_layers=mp["num_up_layers"], attn=True,
                        norm_channels=self.norm_channels, upsample_ch=dc[i],
                        cross_attn=self.text_cond, context_dim=self.text_embed_dim)
                for i in reversed(range(len(dc) - 1)))
            self.norm_out = GroupNorm(self.norm_channels, self.conv_out_channels)
            self.conv_out = Conv2d(self.conv_out_channels, im_channels, 3)

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        """Sinusoidal embedding + 2-layer MLP; timesteps are truncated to
        integers first, as in the JAX package.  Returns float32 (B, D)."""
        t = torch.as_tensor(t, device=self.conv_in.weight.device).to(torch.int32)
        return self.t_proj(get_time_embedding(t, self.t_emb_dim))

    def stem(self, x: torch.Tensor, cond_input: Mapping[str, torch.Tensor] | None = None
             ) -> torch.Tensor:
        """conv_in, with the image conditioning's mask merged in first."""
        if self.image_cond:
            cfg.validate_image_conditional_input(cond_input, x)
            im = self.cond_conv_in(resize_nearest(cond_input["image"], tuple(x.shape[2:])))
            x = torch.cat([x, im], dim=1)
        return self.conv_in(x)

    def encode(self, out: torch.Tensor, t_emb: torch.Tensor,
               context: torch.Tensor | None = None) -> tuple[torch.Tensor, list]:
        """All down blocks; the skips are the *inputs* of each down block."""
        down_outs = []
        for blk in self.downs:
            down_outs.append(out)
            out = blk(out, t_emb, context)
        return out, down_outs

    def mid_stage(self, i: int, out: torch.Tensor, t_emb: torch.Tensor,
                  context: torch.Tensor | None = None) -> torch.Tensor:
        return self.mids[i](out, t_emb, context)

    def decode(self, out: torch.Tensor, down_outs: list, t_emb: torch.Tensor,
               context: torch.Tensor | None = None) -> torch.Tensor:
        down_outs = list(down_outs)
        for blk in self.ups:
            out = blk(out, down_outs.pop(), t_emb, context)
        return self.conv_out(silu(self.norm_out(out)))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond_input: Mapping[str, torch.Tensor] | None = None) -> torch.Tensor:
        """epsilon = UNet(x_t, t [, cond_input]).  x: (B, C, H, W);
        ``cond_input`` holds "class" (B, num_classes), "text" (B, L_ctx,
        text_embed_dim) and "image" (B, C_mask, H', W') as configured."""
        if self.cond and cond_input is None:
            raise ValueError("model initialized with conditioning; cond_input required")
        out = self.stem(x, cond_input)
        t_emb = self.time_embed(t)
        if self.class_cond:
            cfg.validate_class_conditional_input(cond_input, x, self.num_classes)
            # one-hot (B, num_classes) @ (num_classes, D), float32 like t_emb
            t_emb = t_emb + cond_input["class"].to(t_emb.dtype) @ self.class_emb.weight
        context = cond_input.get("text") if self.text_cond else None
        out, down_outs = self.encode(out, t_emb, context)
        for i in range(len(self.mids)):
            out = self.mid_stage(i, out, t_emb, context)
        return self.decode(out, down_outs, t_emb, context)
