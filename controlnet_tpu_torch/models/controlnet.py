"""ControlNet: frozen trained UNet + trainable encoder copy + zero convs.

Port of ``controlnet_tpu/models/controlnet.py`` for the DDPM variant (the
fixed hint block hint_ch -> 64 -> 128 -> C0, ending in a zero conv).  The
dynamic LDM hint block and the fused / paired / transposed-layout forwards
are not ported yet.

Module names follow the reference state dict: ``trained_unet``,
``control_copy_unet``, ``control_copy_unet_hint_block``,
``control_copy_unet_down_zero_convs``, ``control_copy_unet_mid_zero_convs``.

Forward: the frozen trunk's time embedding, stem and down path run under
``torch.no_grad()``; the control branch gets conv_in(x) + hint features;
zero-conv'd control skips are added to the frozen skips that feed the
frozen decoder, and zero-conv'd control mids to the frozen mid outputs.
The frozen mids run outside ``no_grad`` so gradients reach the control
branch through them.  At init every zero conv outputs 0, so ControlNet(x,
t, hint) equals the base UNet(x, t).  A trainer calls ``freeze_trunk`` so
the frozen weights take no gradient.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.nn.layers import Conv2d, Sequential

_DECODER_PREFIXES = ("ups.", "norm_out.", "conv_out.")


def _fixed_hint_block(hint_channels: int, c0: int) -> Sequential:
    """DDPM hint encoder; the SiLUs hold their slots in the state-dict
    indices (0, 2, 4, 6 are convs)."""
    return Sequential(
        Conv2d(hint_channels, 64, 3), nn.SiLU(),
        Conv2d(64, 128, 3), nn.SiLU(),
        Conv2d(128, c0, 3), nn.SiLU(),
        Conv2d(c0, c0, 1, zero_init=True),
    )


class ControlNet(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any],
                 model_locked: bool = True):
        super().__init__()
        self.model_locked = model_locked
        self.trained_unet = UNet(im_channels, model_config)
        self.control_copy_unet = UNet(im_channels, model_config, use_up=False)
        dc = self.trained_unet.down_channels
        mc = self.trained_unet.mid_channels
        self.control_copy_unet_hint_block = _fixed_hint_block(model_config["hint_channels"], dc[0])
        self.control_copy_unet_down_zero_convs = nn.ModuleList(
            Conv2d(dc[i], dc[i], 1, zero_init=True) for i in range(len(dc) - 1))
        self.control_copy_unet_mid_zero_convs = nn.ModuleList(
            Conv2d(mc[i], mc[i], 1, zero_init=True) for i in range(1, len(mc)))

    def init_from_unet(self, unet_state_dict: Mapping[str, torch.Tensor]) -> None:
        """Start both the frozen trunk and the control copy from a trained
        base UNet (the control copy takes its encoder part)."""
        self.trained_unet.load_state_dict(unet_state_dict, strict=True)
        encoder = {k: v for k, v in unet_state_dict.items()
                   if not k.startswith(_DECODER_PREFIXES)}
        self.control_copy_unet.load_state_dict(encoder, strict=True)

    def split_params(self) -> tuple[dict, dict]:
        """(trainable, frozen) parameters by state-dict name.  With
        ``model_locked`` the whole trained UNet is frozen; otherwise its
        decoder trains too."""
        trainable, frozen = {}, {}
        for name, p in self.named_parameters():
            in_trunk = name.startswith("trained_unet.")
            decoder = in_trunk and name[len("trained_unet."):].startswith(_DECODER_PREFIXES)
            if not in_trunk or (decoder and not self.model_locked):
                trainable[name] = p
            else:
                frozen[name] = p
        return trainable, frozen

    def freeze_trunk(self) -> tuple[dict, dict]:
        """``split_params`` for training: the frozen split stops requiring
        gradients (autograd then records no graph for the frozen mid 0 and
        computes no gradient for any frozen weight, as the JAX step never
        differentiates its frozen tree), the trainable split requires them."""
        trainable, frozen = self.split_params()
        for p in trainable.values():
            p.requires_grad_(True)
        for p in frozen.values():
            p.requires_grad_(False)
        return trainable, frozen

    def hint_features(self, hint: torch.Tensor) -> torch.Tensor:
        """Hint-encoder features at conv_in resolution.  The hint is constant
        over a sampling loop, so samplers compute this once."""
        return self.control_copy_unet_hint_block(hint)

    def forward(self, x: torch.Tensor, t: torch.Tensor, hint: torch.Tensor | None = None,
                hint_features: torch.Tensor | None = None) -> torch.Tensor:
        unet, ctrl = self.trained_unet, self.control_copy_unet

        with torch.no_grad():
            f_t_emb = unet.time_embed(t)
            f_out = unet.stem(x)
            f_out, f_down_outs = unet.encode(f_out, f_t_emb)

        c_t_emb = ctrl.time_embed(t)
        if hint_features is None:
            assert hint is not None, "pass hint or precomputed hint_features"
            hint_features = self.hint_features(hint)
        c_out = ctrl.stem(x) + hint_features

        c_down_outs = []
        for i, blk in enumerate(ctrl.downs):
            c_down_outs.append(self.control_copy_unet_down_zero_convs[i](c_out))
            c_out = blk(c_out, c_t_emb)

        m_out = f_out
        for i in range(len(unet.mids)):
            c_out = ctrl.mid_stage(i, c_out, c_t_emb)
            m_out = unet.mid_stage(i, m_out, f_t_emb)
            m_out = m_out + self.control_copy_unet_mid_zero_convs[i](c_out)

        skips = [f + c for f, c in zip(f_down_outs, c_down_outs)]
        return unet.decode(m_out, skips, f_t_emb)
