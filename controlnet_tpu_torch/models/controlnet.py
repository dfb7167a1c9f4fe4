"""ControlNet: frozen trained UNet + trainable encoder copy + zero convs.

Port of ``controlnet_tpu/models/controlnet.py``, both variants in one class:

* DDPM ControlNet: the fixed hint block hint_ch -> 64 -> 128 -> C0 (conv3x3 +
  SiLU), ending in a zero conv.
* LDM ControlNet: pass ``down_sample_factor`` (hint resolution / latent
  resolution) and the hint encoder is built from stride-2 stages that halve
  the resolution and double the channels from 16 until the factor is used up.
  Its ``hint_features`` run in the transposed (C, B, L) layout, where every
  stride-1 3x3 conv is the hand-written kernel of ``ops/cuda_conv.py``.

Three more forwards compute the same function for sampling, as in the JAX
package: ``forward_tl`` in the transposed (C, B, L) layout (every stride-1
3x3 conv of both trunks is kernel c), ``forward_paired`` with the two trunks
advanced in lockstep so that each layer's two self-attention cores run as one
kernel-a call at twice the batch, and ``forward_fused`` with the two
encoder trunks joined on the channel axis (``nn/blocks.py``).  Each keeps
``forward``'s gradients, and each raises under tensor parallelism.  No tool
calls them: every tool samples through ``forward``.

Module names follow the reference state dicts.  DDPM: ``trained_unet``,
``control_copy_unet``, ``control_copy_unet_hint_block``,
``control_copy_unet_down_zero_convs``, ``control_copy_unet_mid_zero_convs``.
LDM: the same with the infix ``control_unet``, and the hint block nested, one
``Sequential`` per stage.  The ``control``, ``hint_block``, ``down_zero_convs``
and ``mid_zero_convs`` properties name them for either variant.

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
import torch.nn.functional as F
from torch import nn

from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.nn.layers import Conv2d, Sequential
from controlnet_tpu_torch.ops import tl_conv

_DECODER_PREFIXES = ("ups.", "norm_out.", "conv_out.")


def fixed_hint_block(hint_channels: int, c0: int, zero_init: bool = True) -> Sequential:
    """DDPM hint encoder; the SiLUs hold their slots in the state-dict
    indices (0, 2, 4, 6 are convs).  The consistency student's copy keeps
    its last conv's random init (``zero_init=False``)."""
    return Sequential(
        Conv2d(hint_channels, 64, 3), nn.SiLU(),
        Conv2d(64, 128, 3), nn.SiLU(),
        Conv2d(128, c0, 3), nn.SiLU(),
        Conv2d(c0, c0, 1, zero_init=zero_init),
    )


def _dynamic_hint_block(hint_channels: int, c0: int, down_sample_factor: int) -> Sequential:
    """LDM hint encoder: stride-2 stages until the hint resolution matches
    the latent resolution.  Nested as the reference state dict is: stage 0 is
    (conv, SiLU), each middle stage (stride-2 conv, SiLU, conv), the last
    (conv, SiLU, zero conv)."""
    if down_sample_factor < 1 or down_sample_factor & (down_sample_factor - 1):
        raise ValueError(
            f"down_sample_factor must be a power of two, got {down_sample_factor} "
            "(each hint-encoder stage downsamples by exactly 2; a non-power-of-two "
            "factor would leave the hint features misaligned with the latents)")
    stages = [Sequential(Conv2d(hint_channels, 16, 3), nn.SiLU())]
    base = 16
    factor = down_sample_factor
    while factor > 1:
        stages.append(Sequential(Conv2d(base, base * 2, 3, stride=2, padding=1), nn.SiLU(),
                                 Conv2d(base * 2, base * 2, 3)))
        base *= 2
        factor //= 2
    stages.append(Sequential(Conv2d(base, c0, 3), nn.SiLU(), Conv2d(c0, c0, 1, zero_init=True)))
    return Sequential(*stages)


class ControlNet(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any],
                 model_locked: bool = True, down_sample_factor: int | None = None):
        super().__init__()
        self.model_locked = model_locked
        self.down_sample_factor = down_sample_factor
        self._infix = "control_copy_unet" if down_sample_factor is None else "control_unet"
        self.trained_unet = UNet(im_channels, model_config)
        dc = self.trained_unet.down_channels
        mc = self.trained_unet.mid_channels
        self.add_module(self._infix, UNet(im_channels, model_config, use_up=False))
        if down_sample_factor is None:
            hint_block = fixed_hint_block(model_config["hint_channels"], dc[0])
        else:
            hint_block = _dynamic_hint_block(model_config["hint_channels"], dc[0],
                                             down_sample_factor)
        self.add_module(f"{self._infix}_hint_block", hint_block)
        self.add_module(f"{self._infix}_down_zero_convs", nn.ModuleList(
            Conv2d(dc[i], dc[i], 1, zero_init=True) for i in range(len(dc) - 1)))
        self.add_module(f"{self._infix}_mid_zero_convs", nn.ModuleList(
            Conv2d(mc[i], mc[i], 1, zero_init=True) for i in range(1, len(mc))))

    @property
    def control(self) -> UNet:
        """The trainable encoder copy."""
        return getattr(self, self._infix)

    @property
    def hint_block(self) -> Sequential:
        return getattr(self, f"{self._infix}_hint_block")

    @property
    def down_zero_convs(self) -> nn.ModuleList:
        return getattr(self, f"{self._infix}_down_zero_convs")

    @property
    def mid_zero_convs(self) -> nn.ModuleList:
        return getattr(self, f"{self._infix}_mid_zero_convs")

    def zero_convs(self) -> list:
        """Every zero-initialised conv: down, mid, and the hint block's last."""
        last = self.hint_block[-1]
        hint_zero = last[-1] if isinstance(last, Sequential) else last
        return list(self.down_zero_convs) + list(self.mid_zero_convs) + [hint_zero]

    def init_from_unet(self, unet_state_dict: Mapping[str, torch.Tensor]) -> None:
        """Start both the frozen trunk and the control copy from a trained
        base UNet (the control copy takes its encoder part)."""
        self.trained_unet.load_state_dict(unet_state_dict, strict=True)
        encoder = {k: v for k, v in unet_state_dict.items()
                   if not k.startswith(_DECODER_PREFIXES)}
        self.control.load_state_dict(encoder, strict=True)

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
        over a sampling loop, so samplers compute this once.

        The dynamic (LDM) encoder runs in the transposed (C, B, L) layout of
        ``ops/tl_conv.py``: the hint is read through its (C, B, L) view
        without a copy, and only the small result is copied back to
        contiguous NCHW."""
        if self.down_sample_factor is not None:
            out, out_hw = self.hint_block.tl(tl_conv.to_tl(hint), tuple(hint.shape[2:]))
            return tl_conv.from_tl(out, out_hw).contiguous()
        return self.hint_block(hint)

    def hint_features_chunked(self, hint: torch.Tensor, chunk: int = 16) -> torch.Tensor:
        """``hint_features`` in batch chunks.  The full-resolution encoder's
        working set grows with the batch; chunking bounds it to ``chunk``
        samples.  The encoder has no cross-batch operation, and the
        hand-written conv kernel sums each output in one order whatever the
        batch unless its planner splits the input channels another way
        (``cuda_conv.f32_launch_plan``; the encoder's layers take no split
        from batch 16 up), so the result is bit-identical to the unchunked
        one wherever that holds and the library's stride-2 convolution does
        not pick another algorithm for another batch size (else it differs
        by float rounding)."""
        n = hint.shape[0]
        if n <= chunk:
            return self.hint_features(hint)
        return torch.cat([self.hint_features(hint[i:i + chunk]) for i in range(0, n, chunk)])

    def _features(self, hint: torch.Tensor | None,
                  hint_features: torch.Tensor | None) -> torch.Tensor:
        if hint_features is None:
            assert hint is not None, "pass hint or precomputed hint_features"
            hint_features = self.hint_features(hint)
        return hint_features

    def forward(self, x: torch.Tensor, t: torch.Tensor, hint: torch.Tensor | None = None,
                hint_features: torch.Tensor | None = None) -> torch.Tensor:
        unet, ctrl = self.trained_unet, self.control

        with torch.no_grad():
            f_t_emb = unet.time_embed(t)
            f_out = unet.stem(x)
            f_out, f_down_outs = unet.encode(f_out, f_t_emb)

        c_t_emb = ctrl.time_embed(t)
        c_out = ctrl.stem(x) + self._features(hint, hint_features)

        c_down_outs = []
        for i, blk in enumerate(ctrl.downs):
            c_down_outs.append(self.down_zero_convs[i](c_out))
            c_out = blk(c_out, c_t_emb)

        m_out = f_out
        for i in range(len(unet.mids)):
            c_out = ctrl.mid_stage(i, c_out, c_t_emb)
            m_out = unet.mid_stage(i, m_out, f_t_emb)
            m_out = m_out + self.mid_zero_convs[i](c_out)

        skips = [f + c for f, c in zip(f_down_outs, c_down_outs)]
        return unet.decode(m_out, skips, f_t_emb)

    def forward_tl(self, x: torch.Tensor, t: torch.Tensor, hint: torch.Tensor | None = None,
                   hint_features: torch.Tensor | None = None) -> torch.Tensor:
        """``forward`` in the transposed layout (NCHW in and out).  The hint
        encoder runs as ``hint_features`` runs it (once a sampling loop); the
        zero convs are ``conv1x1_tl``."""
        unet, ctrl = self.trained_unet, self.control

        with torch.no_grad():
            f_t_emb = unet.time_embed(t)
            f_out, hw0 = unet.stem_tl(x)
            f_out, f_down_outs, hws, hw = unet.encode_tl(f_out, f_t_emb, hw0)

        c_t_emb = ctrl.time_embed(t)
        c_out, c_hw = ctrl.stem_tl(x)
        c_out = c_out + tl_conv.to_tl(self._features(hint, hint_features))
        c_down_outs = []
        for i, blk in enumerate(ctrl.downs):
            c_down_outs.append(self.down_zero_convs[i].tl(c_out, c_hw))
            c_out = blk.tl(c_out, c_t_emb, hw=c_hw)
            if ctrl.down_sample[i]:
                c_hw = (c_hw[0] // 2, c_hw[1] // 2)

        m_out = f_out
        for i in range(len(unet.mids)):
            c_out = ctrl.mid_stage_tl(i, c_out, c_t_emb, c_hw)
            m_out = unet.mid_stage_tl(i, m_out, f_t_emb, hw)
            m_out = m_out + self.mid_zero_convs[i].tl(c_out, c_hw)

        skips = [f + c for f, c in zip(f_down_outs, c_down_outs)]
        return unet.decode_tl(m_out, skips, hws, f_t_emb, hw)

    def forward_paired(self, x: torch.Tensor, t: torch.Tensor, hint: torch.Tensor | None = None,
                       hint_features: torch.Tensor | None = None) -> torch.Tensor:
        """``forward`` with the frozen and control trunks advanced block by
        block in lockstep: each layer's two self-attention cores run as one
        attention call at twice the batch (``DownBlock.pair``,
        ``MidBlock.pair``); convs stay per trunk.  The frozen down path
        takes no gradient, as under ``forward``'s ``no_grad``: its block
        outputs are detached (the joint attention call would otherwise carry
        the control trunk's graph into it)."""
        unet, ctrl = self.trained_unet, self.control

        with torch.no_grad():
            f_t_emb = unet.time_embed(t)
            f_out = unet.stem(x)
        c_t_emb = ctrl.time_embed(t)
        c_out = ctrl.stem(x) + self._features(hint, hint_features)

        f_down_outs, c_down_outs = [], []
        for i, (f_blk, c_blk) in enumerate(zip(unet.downs, ctrl.downs)):
            f_down_outs.append(f_out)
            c_down_outs.append(self.down_zero_convs[i](c_out))
            f_out, c_out = f_blk.pair(c_blk, f_out, c_out, f_t_emb, c_t_emb)
            f_out = f_out.detach()

        m_out = f_out
        for i in range(len(unet.mids)):
            m_out, c_out = unet.mids[i].pair(ctrl.mids[i], m_out, c_out, f_t_emb, c_t_emb)
            m_out = m_out + self.mid_zero_convs[i](c_out)

        skips = [f + c for f, c in zip(f_down_outs, c_down_outs)]
        return unet.decode(m_out, skips, f_t_emb)

    def forward_fused(self, x: torch.Tensor, t: torch.Tensor, hint: torch.Tensor | None = None,
                      hint_features: torch.Tensor | None = None) -> torch.Tensor:
        """``forward`` with the frozen and control encoder trunks as one
        stream, joined on the channel axis (frozen first): conv_in, the down
        blocks and the mids run each layer pair as one call
        (``DownBlock.fused``, ``MidBlock.fused``: ``groups=2`` convolutions,
        group norms of twice the groups, attention at twice the batch).  The
        frozen trunk's conv_in and down weights take no gradient; its mids
        do, as under ``forward``.  The PyTorch form of the JAX package's
        ``vmap`` over the stacked trunks."""
        unet, ctrl = self.trained_unet, self.control
        if any(getattr(m, "tp_mesh", None) is not None for m in self.modules()):
            raise NotImplementedError("no fused forward under tensor parallelism")

        with torch.no_grad():
            f_t_emb = unet.time_embed(t)
        c_t_emb = ctrl.time_embed(t)
        feats = self._features(hint, hint_features)

        w = torch.cat([unet.conv_in.weight.detach(), ctrl.conv_in.weight]).to(x.dtype)
        b = torch.cat([unet.conv_in.bias.detach(), ctrl.conv_in.bias]).to(x.dtype)
        out2 = F.conv2d(x, w, b, padding=1)  # both trunks read x
        c = out2.shape[1] // 2
        out2 = torch.cat([out2[:, :c], out2[:, c:] + feats], dim=1)

        skips = []
        for i, (f_blk, c_blk) in enumerate(zip(unet.downs, ctrl.downs)):
            c = out2.shape[1] // 2
            skips.append(out2[:, :c] + self.down_zero_convs[i](out2[:, c:]))
            out2 = f_blk.fused(c_blk, out2, f_t_emb, c_t_emb, stop_a=True)

        c = out2.shape[1] // 2
        m_out, c_out = out2[:, :c], out2[:, c:]
        for i in range(len(unet.mids)):
            out2 = unet.mids[i].fused(ctrl.mids[i], torch.cat([m_out, c_out], dim=1), f_t_emb,
                                      c_t_emb)
            c = out2.shape[1] // 2
            c_out = out2[:, c:]
            m_out = out2[:, :c] + self.mid_zero_convs[i](c_out)

        return unet.decode(m_out, skips, f_t_emb)
