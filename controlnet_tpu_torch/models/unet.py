"""The unconditioned UNet (epsilon prediction), NCHW.

Port of ``controlnet_tpu/models/unet.py``'s base path: defaults reproduce
the reference base UNet (GroupNorm(8), attention at every level, a 16-wide
last decoder stage).  The class, text and image conditioning branches are
not ported yet; a config that asks for them raises.

    conv_in -> downs (skips saved) -> mids -> ups (skip concat) ->
    norm_out -> SiLU -> conv_out

The staged methods (``time_embed``, ``stem``, ``encode``, ``mid_stage``,
``decode``) are what ControlNet composes.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.nn.blocks import DownBlock, MidBlock, UpBlock
from controlnet_tpu_torch.nn.layers import (Conv2d, GroupNorm, Linear, Sequential,
                                            get_time_embedding, silu)


class UNet(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any], use_up: bool = True):
        super().__init__()
        mp = model_config
        cfg.validate_unet_model_params(mp)
        if cfg.get_config_value(mp, "condition_config") is not None:
            raise NotImplementedError("UNet conditioning (class/text/image) is not ported yet")
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

        self.conv_in = Conv2d(im_channels, self.down_channels[0], 3)
        self.t_proj = Sequential(Linear(self.t_emb_dim, self.t_emb_dim), nn.SiLU(),
                                 Linear(self.t_emb_dim, self.t_emb_dim))
        dc = self.down_channels
        self.downs = nn.ModuleList(
            DownBlock(dc[i], dc[i + 1], self.t_emb_dim, down_sample=self.down_sample[i],
                      num_heads=self.num_heads, num_layers=mp["num_down_layers"],
                      attn=self.attns[i], norm_channels=self.norm_channels)
            for i in range(len(dc) - 1))
        mc = self.mid_channels
        self.mids = nn.ModuleList(
            MidBlock(mc[i], mc[i + 1], self.t_emb_dim, num_heads=self.num_heads,
                     num_layers=mp["num_mid_layers"], norm_channels=self.norm_channels)
            for i in range(len(mc) - 1))
        if use_up:
            # i walks len(dc)-2 .. 0; the input is [upsampled || skip], both dc[i] wide
            self.ups = nn.ModuleList(
                UpBlock(dc[i] * 2, dc[i - 1] if i != 0 else self.conv_out_channels,
                        self.t_emb_dim, up_sample=self.down_sample[i], num_heads=self.num_heads,
                        num_layers=mp["num_up_layers"], attn=True,
                        norm_channels=self.norm_channels, upsample_ch=dc[i])
                for i in reversed(range(len(dc) - 1)))
            self.norm_out = GroupNorm(self.norm_channels, self.conv_out_channels)
            self.conv_out = Conv2d(self.conv_out_channels, im_channels, 3)

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        """Sinusoidal embedding + 2-layer MLP; timesteps are truncated to
        integers first, as in the JAX package.  Returns float32 (B, D)."""
        t = torch.as_tensor(t, device=self.conv_in.weight.device).to(torch.int32)
        return self.t_proj(get_time_embedding(t, self.t_emb_dim))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_in(x)

    def encode(self, out: torch.Tensor, t_emb: torch.Tensor) -> tuple[torch.Tensor, list]:
        """All down blocks; the skips are the *inputs* of each down block."""
        down_outs = []
        for blk in self.downs:
            down_outs.append(out)
            out = blk(out, t_emb)
        return out, down_outs

    def mid_stage(self, i: int, out: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        return self.mids[i](out, t_emb)

    def decode(self, out: torch.Tensor, down_outs: list, t_emb: torch.Tensor) -> torch.Tensor:
        down_outs = list(down_outs)
        for blk in self.ups:
            out = blk(out, down_outs.pop(), t_emb)
        return self.conv_out(silu(self.norm_out(out)))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """epsilon = UNet(x_t, t).  x: (B, C, H, W)."""
        out = self.stem(x)
        t_emb = self.time_embed(t)
        out, down_outs = self.encode(out, t_emb)
        for i in range(len(self.mids)):
            out = self.mid_stage(i, out, t_emb)
        return self.decode(out, down_outs, t_emb)
