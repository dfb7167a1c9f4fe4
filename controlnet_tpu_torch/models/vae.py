"""KL autoencoder (VAE) for latent diffusion, NCHW.

Port of ``controlnet_tpu/models/vae.py``: encoder = conv_in + DownBlocks +
MidBlocks + norm/SiLU/conv_out (2*z channels) + 1x1 pre-quant conv; a
reparameterized sample; decoder = 1x1 post-quant conv + conv_in + MidBlocks +
UpBlocks (no skip concat) + norm/SiLU/conv_out.  The blocks take no time
embedding and have per-level attention flags.  Module names are the
reference state dict's, so a reference-format ``.pth`` loads strictly.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.nn.blocks import DownBlock, MidBlock, UpBlock
from controlnet_tpu_torch.nn.layers import Conv2d, GroupNorm, silu


class VAE(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any]):
        super().__init__()
        mp = model_config
        cfg.validate_vae_model_params(mp)
        self.im_channels = im_channels
        self.z_channels = mp["z_channels"]
        dc, mc, nc = list(mp["down_channels"]), list(mp["mid_channels"]), mp["norm_channels"]
        down_sample, attns, heads = list(mp["down_sample"]), list(mp["attn_down"]), mp["num_heads"]
        z = self.z_channels

        def mid(in_ch, out_ch):
            return MidBlock(in_ch, out_ch, None, num_heads=heads,
                            num_layers=mp["num_mid_layers"], norm_channels=nc)

        self.encoder_conv_in = Conv2d(im_channels, dc[0], 3)
        self.encoder_layers = nn.ModuleList(
            DownBlock(dc[i], dc[i + 1], None, down_sample=down_sample[i], num_heads=heads,
                      num_layers=mp["num_down_layers"], attn=attns[i], norm_channels=nc)
            for i in range(len(dc) - 1))
        self.encoder_mids = nn.ModuleList(mid(mc[i], mc[i + 1]) for i in range(len(mc) - 1))
        self.encoder_norm_out = GroupNorm(nc, dc[-1])
        self.encoder_conv_out = Conv2d(dc[-1], 2 * z, 3)
        self.pre_quant_conv = Conv2d(2 * z, 2 * z, 1)

        self.post_quant_conv = Conv2d(z, z, 1)
        self.decoder_conv_in = Conv2d(z, mc[-1], 3)
        self.decoder_mids = nn.ModuleList(
            mid(mc[i], mc[i - 1]) for i in reversed(range(1, len(mc))))
        # no skip concat in a VAE decoder: the upsample keeps the input width
        self.decoder_layers = nn.ModuleList(
            UpBlock(dc[i], dc[i - 1], None, up_sample=down_sample[i - 1], num_heads=heads,
                    num_layers=mp["num_up_layers"], attn=attns[i - 1], norm_channels=nc,
                    upsample_ch=dc[i])
            for i in reversed(range(1, len(dc))))
        self.decoder_norm_out = GroupNorm(nc, dc[0])
        self.decoder_conv_out = Conv2d(dc[0], im_channels, 3)

    def moments(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder output before sampling: (B, 2*z, h, w) = mean || logvar."""
        out = self.encoder_conv_in(x)
        for blk in self.encoder_layers:
            out = blk(out)
        for blk in self.encoder_mids:
            out = blk(out)
        out = self.encoder_conv_out(silu(self.encoder_norm_out(out)))
        return self.pre_quant_conv(out)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(reparameterized sample, mean || logvar).  The standard-normal
        ``noise`` (shape of the mean) is drawn from ``generator`` unless a
        caller injects it; under a data-parallel ``mesh`` ``x`` is this
        rank's rows and the noise is drawn at the global batch's shape and
        sliced."""
        enc = self.moments(x)
        mean, logvar = torch.chunk(enc, 2, dim=1)
        if noise is None:
            from controlnet_tpu_torch.sample.common import global_batch, rank_rows

            noise = rank_rows(torch.randn((global_batch(mean.shape[0], mesh), *mean.shape[1:]),
                                          generator=generator, device=mean.device,
                                          dtype=mean.dtype), mesh)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype), enc

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        out = self.decoder_conv_in(self.post_quant_conv(z))
        for blk in self.decoder_mids:
            out = blk(out)
        for blk in self.decoder_layers:
            out = blk(out)
        return self.decoder_conv_out(silu(self.decoder_norm_out(out)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
        z, enc = self.encode(x, generator, noise, mesh)
        return self.decode(z), enc
