"""Weights carried across from the JAX package, and reference ``.pth`` files.

``unet_state_dict_from_jax`` / ``controlnet_state_dict_from_jax`` /
``vae_state_dict_from_jax`` / ``student_state_dict_from_jax`` /
``features_state_dict_from_jax`` / ``discriminator_state_dict_from_jax`` /
``lpips_state_dict_from_jax`` take the JAX package's parameter trees (nested
dicts and lists of numpy arrays) and return this package's ``state_dict``,
which is the reference PyTorch one.
This is the port's own numpy-only copy of the layout rules of
``controlnet_tpu/io/torch_export.py``:

  * Conv2d:           HWIO -> OIHW
  * ConvTranspose2d:  the JAX kernel is stored spatially flipped; un-flip,
                      then HWIO -> (in, out, kh, kw)
  * Linear:           (in, out) -> (out, in)
  * MultiheadAttention: wq/wk/wv packed into in_proj_weight (3D, D),
                      out_proj transposed
  * GroupNorm, BatchNorm: scale -> weight, bias -> bias
  * a conditional UNet's ``class_emb`` (num_classes, D) -> ``class_emb.weight``
    as is; each cross-attention layer (``xattns.j``) -> ``cross_attention_norms.j``,
    ``cross_attentions.j`` and ``context_proj.j``
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = Any


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(p: Params, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).transpose(3, 2, 0, 1)
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _conv_transpose(p: Params, prefix: str, out: dict) -> None:
    w = _np(p["w"])[::-1, ::-1]
    out[f"{prefix}.weight"] = w.transpose(2, 3, 0, 1)
    out[f"{prefix}.bias"] = _np(p["b"])


def _linear(p: Params, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _norm(p: Params, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _attention(p: Params, prefix: str, out: dict) -> None:
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_np(p["wq"]).T, _np(p["wk"]).T, _np(p["wv"]).T], axis=0)
    out[f"{prefix}.in_proj_bias"] = np.concatenate([_np(p["bq"]), _np(p["bk"]), _np(p["bv"])])
    out[f"{prefix}.out_proj.weight"] = _np(p["wo"]).T
    out[f"{prefix}.out_proj.bias"] = _np(p["bo"])


def _block(p: Params, base: str, out: dict) -> None:
    for j, rp in enumerate(p["resnets"]):
        _norm(rp["norm1"], f"{base}.resnet_conv_first.{j}.0", out)
        _conv(rp["conv1"], f"{base}.resnet_conv_first.{j}.2", out)
        _norm(rp["norm2"], f"{base}.resnet_conv_second.{j}.0", out)
        _conv(rp["conv2"], f"{base}.resnet_conv_second.{j}.2", out)
        _conv(rp["skip"], f"{base}.residual_input_conv.{j}", out)
        if "t_proj" in rp:
            _linear(rp["t_proj"], f"{base}.t_emb_layers.{j}.1", out)
    for j, ap in enumerate(p.get("attns", [])):
        _norm(ap["norm"], f"{base}.attention_norms.{j}", out)
        _attention(ap["attn"], f"{base}.attentions.{j}", out)
    for j, ap in enumerate(p.get("xattns", [])):
        _norm(ap["norm"], f"{base}.cross_attention_norms.{j}", out)
        _attention(ap["attn"], f"{base}.cross_attentions.{j}", out)
        _linear(ap["ctx_proj"], f"{base}.context_proj.{j}", out)
    if p.get("down"):
        _conv(p["down"], f"{base}.down_sample_conv", out)
    if p.get("up"):
        _conv_transpose(p["up"], f"{base}.up_sample_conv", out)


def _to_torch(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _unet(p: Params, prefix: str, out: dict) -> None:
    _conv(p["conv_in"], f"{prefix}conv_in", out)
    _linear(p["t_proj1"], f"{prefix}t_proj.0", out)
    _linear(p["t_proj2"], f"{prefix}t_proj.2", out)
    for i, bp in enumerate(p["downs"]):
        _block(bp, f"{prefix}downs.{i}", out)
    for i, bp in enumerate(p["mids"]):
        _block(bp, f"{prefix}mids.{i}", out)
    if "class_emb" in p:
        out[f"{prefix}class_emb.weight"] = _np(p["class_emb"])
    if "cond_conv_in" in p:
        _conv(p["cond_conv_in"], f"{prefix}cond_conv_in", out)
    if "ups" in p:
        for i, bp in enumerate(p["ups"]):
            _block(bp, f"{prefix}ups.{i}", out)
        _norm(p["norm_out"], f"{prefix}norm_out", out)
        _conv(p["conv_out"], f"{prefix}conv_out", out)


def unet_state_dict_from_jax(params: Params, prefix: str = "") -> dict:
    """JAX ``UNet`` parameter tree -> this package's ``UNet`` state dict."""
    sd: dict = {}
    _unet(params, prefix, sd)
    return _to_torch(sd)


def _hint_block(layers: list, prefix: str, nested: bool, out: dict) -> None:
    """The JAX Sequential's per-step params (each activation an empty slot)
    -> the reference key paths.  Flat (the DDPM hint block): the torch index
    of a conv is its position in the steps list.  Nested (the LDM hint
    block): one Sequential per stage; stage 0 is (conv, silu), each middle
    stage (conv, silu, conv), the last (conv, silu, zero conv)."""
    if not nested:
        for i, lp in enumerate(layers):
            if lp:
                _conv(lp, f"{prefix}.{i}", out)
        return
    convs = [lp for lp in layers if lp]
    n_stages = (len(convs) - 1) // 2  # 1 head conv + 2 per remaining stage
    _conv(convs[0], f"{prefix}.0.0", out)
    for stage in range(1, n_stages + 1):
        _conv(convs[2 * stage - 1], f"{prefix}.{stage}.0", out)
        _conv(convs[2 * stage], f"{prefix}.{stage}.2", out)


def controlnet_state_dict_from_jax(params: Params, ldm: bool = False) -> dict:
    """JAX ``ControlNet`` tree -> this package's ``ControlNet`` state dict.
    ``ldm`` is the variant built with ``down_sample_factor``: the infix
    ``control_unet`` and the nested hint block; else ``control_copy_unet``
    and the flat one."""
    infix = "control_unet" if ldm else "control_copy_unet"
    sd: dict = {}
    _unet(params["trained_unet"], "trained_unet.", sd)
    _unet(params["control_unet"], f"{infix}.", sd)
    _hint_block(params["hint_block"]["layers"], f"{infix}_hint_block", ldm, sd)
    for i, zp in enumerate(params["down_zero"]):
        _conv(zp, f"{infix}_down_zero_convs.{i}", sd)
    for i, zp in enumerate(params["mid_zero"]):
        _conv(zp, f"{infix}_mid_zero_convs.{i}", sd)
    return _to_torch(sd)


def vae_state_dict_from_jax(params: Params) -> dict:
    """JAX ``VAE`` tree -> this package's ``VAE`` state dict."""
    sd: dict = {}
    for name in ("encoder_conv_in", "encoder_conv_out", "pre_quant_conv", "post_quant_conv",
                 "decoder_conv_in", "decoder_conv_out"):
        _conv(params[name], name, sd)
    for name in ("encoder_layers", "encoder_mids", "decoder_mids", "decoder_layers"):
        for i, bp in enumerate(params[name]):
            _block(bp, f"{name}.{i}", sd)
    _norm(params["encoder_norm_out"], "encoder_norm_out", sd)
    _norm(params["decoder_norm_out"], "decoder_norm_out", sd)
    return _to_torch(sd)


def discriminator_state_dict_from_jax(params: Params) -> dict:
    """JAX PatchGAN ``Discriminator`` tree -> this package's state dict
    (``layers.{i}.0`` conv, ``layers.{i}.1`` batch norm)."""
    sd: dict = {}
    for i, cp in enumerate(params["convs"]):
        _conv(cp, f"layers.{i}.0", sd)
    for i, npar in enumerate(params["norms"]):
        if npar:
            _norm(npar, f"layers.{i}.1", sd)
    return _to_torch(sd)


def lpips_state_dict_from_jax(params: Params) -> dict:
    """JAX ``LPIPS`` tree -> this package's LPIPS state dict: the VGG convs
    at their torchvision indices (``net.slice{s}.{i}``), the heads as
    ``lin{k}.model.1``."""
    from controlnet_tpu_torch.models.lpips import SLICE_CONVS

    sd: dict = {}
    for s, idxs in SLICE_CONVS.items():
        for cp, i in zip(params["vgg"][s - 1], idxs):
            _conv(cp, f"net.slice{s}.{i}", sd)
    for k, lp in enumerate(params["lins"]):
        _conv(lp, f"lin{k}.model.1", sd)
    return _to_torch(sd)


def student_state_dict_from_jax(params: Params) -> dict:
    """JAX consistency or DMD student tree -> this package's student state
    dict: ``unet.*``, the flat ``hint_block.{i}`` and ``t_proj.1`` (the
    reference's ``t_proj`` is ``Sequential(SiLU, Linear)``)."""
    sd: dict = {}
    _unet(params["unet"], "unet.", sd)
    _hint_block(params["hint_block"]["layers"], "hint_block", False, sd)
    _linear(params["t_proj"], "t_proj.1", sd)
    return _to_torch(sd)


def features_state_dict_from_jax(params: Params) -> dict:
    """JAX DMD ``FeatureExtractor`` tree -> ``FeatureExtractor`` state dict
    (``stages.{i}.conv1|bn1|conv2|bn2``)."""
    sd: dict = {}
    for i, sp in enumerate(params["stages"]):
        for name in ("conv1", "conv2"):
            _conv(sp[name], f"stages.{i}.{name}", sd)
        for name in ("bn1", "bn2"):
            _norm(sp[name], f"stages.{i}.{name}", sd)
    return _to_torch(sd)


def load_student_checkpoint(path: str) -> dict:
    """A reference-format distilled-student ``.pth`` -> its dict, tensors on
    the CPU.  The consistency wrapper holds ``epoch``, ``model_state_dict``,
    ``ema_teacher_state_dict`` and ``model_config``; the DMD one ``epoch``,
    ``model_state_dict`` and ``config``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model_state_dict" not in ckpt:
        raise ValueError(f"{path}: not a distilled-student checkpoint (no model_state_dict)")
    return ckpt


def load_reference_checkpoint(path: str) -> dict:
    """A reference-format ControlNet or VAE ``.pth`` (a bare state dict, as
    ``tools/export_torch_checkpoint.py`` writes it) -> CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)
