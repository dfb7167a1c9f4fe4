"""LPIPS perceptual distance over VGG16 features, NCHW.

Port of ``controlnet_tpu/models/lpips.py``: the inputs are shifted and
scaled channel by channel (ImageNet statistics), run through the five VGG16
stages (relu1_2 .. relu5_3, max-pool between stages), each stage's features
are normalised to unit length over the channels, their squared difference is
weighted by a 1x1 "lin" head and averaged over space, and the five levels are
summed: one distance per sample, (B, 1, 1, 1).

Module names are the reference LPIPS state dict's: the VGG layers sit at
their torchvision indices in ``net.slice1`` .. ``net.slice5`` (convs at 0, 2 |
5, 7 | 10, 12, 14 | 17, 19, 21 | 24, 26, 28) and the heads are
``lin{k}.model.1`` (``model.0`` is the reference's dropout, which a frozen
net never applies).

The pretrained weights are not in the repository.  Without them
(``load_torch_weights``) the VGG convs keep a Kaiming-normal init and the
heads a uniform one in [0, 0.1), drawn from a ``torch.Generator``: frozen
random features.  The net is frozen and always float32.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

# (out channels, convs) per VGG16 stage; the torchvision index of each conv
VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
SLICE_CONVS = {1: [0, 2], 2: [5, 7], 3: [10, 12, 14], 4: [17, 19, 21], 5: [24, 26, 28]}
LIN_CHANNELS = [64, 128, 256, 512, 512]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def _vgg_slices() -> nn.Module:
    net = nn.Module()
    in_ch, index = 3, 0
    for s, (out_ch, n_convs) in enumerate(VGG_STAGES, start=1):
        stage = nn.Sequential()
        if s > 1:
            stage.add_module(str(index), nn.MaxPool2d(2, 2))
            index += 1
        for _ in range(n_convs):
            stage.add_module(str(index), nn.Conv2d(in_ch, out_ch, 3, padding=1))
            stage.add_module(str(index + 1), nn.ReLU())
            in_ch, index = out_ch, index + 2
        net.add_module(f"slice{s}", stage)
    return net


class LPIPS(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.net = _vgg_slices()
        for k, c in enumerate(LIN_CHANNELS):
            self.add_module(f"lin{k}", nn.Module())
            getattr(self, f"lin{k}").model = nn.Sequential(nn.Identity(),
                                                           nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.reset_parameters(generator)
        self.requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Kaiming-normal VGG convs (std sqrt(2 / (Cin * 9))), zero biases,
        heads uniform in [0, 0.1), drawn from ``generator``."""
        for conv in self.vgg_convs():
            std = math.sqrt(2.0 / (conv.in_channels * 9))
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
            conv.bias.zero_()
        for lin in self.lins():
            lin.weight.copy_(torch.rand(lin.weight.shape, generator=generator) * 0.1)

    def vgg_convs(self) -> list:
        return [getattr(getattr(self.net, f"slice{s}"), str(i)) for s, idx in SLICE_CONVS.items()
                for i in idx]

    def lins(self) -> list:
        return [getattr(self, f"lin{k}").model[1] for k in range(len(LIN_CHANNELS))]

    def features(self, x: torch.Tensor) -> list:
        feats = []
        for s in range(1, len(VGG_STAGES) + 1):
            x = getattr(self.net, f"slice{s}")(x)
            feats.append(x)
        return feats

    def forward(self, in0: torch.Tensor, in1: torch.Tensor,
                normalize: bool = False) -> torch.Tensor:
        """Per-sample distance (B, 1, 1, 1) of NCHW images in [-1, 1] (in [0,
        1] with ``normalize``); one-channel images are repeated to three.
        Computed in float32."""
        in0, in1 = in0.float(), in1.float()
        if normalize:
            in0, in1 = 2 * in0 - 1, 2 * in1 - 1
        if in0.shape[1] == 1:
            in0, in1 = in0.repeat(1, 3, 1, 1), in1.repeat(1, 3, 1, 1)
        f0 = self.features((in0 - self.shift) / self.scale)
        f1 = self.features((in1 - self.shift) / self.scale)
        val = 0.0
        for a, b, lin in zip(f0, f1, self.lins()):
            n0 = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            n1 = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            val = val + F.conv2d((n0 - n1) ** 2, lin.weight).mean(dim=(2, 3), keepdim=True)
        return val


def load_torch_weights(model: LPIPS, path: str, have_vgg: bool = False) -> bool:
    """Load torch LPIPS weights from ``path`` into ``model``; returns whether
    ``model`` now holds pretrained VGG features.

    Takes a full dump with the VGG features (``net.slice{s}.{i}.weight`` /
    ``.bias``) and / or lin heads (``lin{k}.model.1.weight``, or
    ``lins.{k}.model.1.weight``).  The heads are loaded only alongside the
    features they were trained over: from this file, or from an earlier call
    (pass its result as ``have_vgg``).  A lin-only file over random features
    is ignored, with a message."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    found_vgg = False
    with torch.no_grad():
        for s, idxs in SLICE_CONVS.items():
            for i in idxs:
                key = f"net.slice{s}.{i}"
                if f"{key}.weight" in sd:
                    found_vgg = True
                    conv = getattr(getattr(model.net, f"slice{s}"), str(i))
                    conv.weight.copy_(sd[f"{key}.weight"])
                    conv.bias.copy_(sd[f"{key}.bias"])
        lins = {}
        for k in range(len(LIN_CHANNELS)):
            for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
                if key in sd:
                    lins[k] = sd[key]
                    break
        if lins and (found_vgg or have_vgg):
            for k, w in lins.items():
                model.lins()[k].weight.copy_(w)
        elif lins:
            print(f"LPIPS: {path} carries lin heads but no VGG features; ignoring them "
                  "(pretrained weightings mean something only over the matching pretrained "
                  "channels); keeping the uniform random-feature fallback")
    return found_vgg or have_vgg


def default_weights_path() -> str:
    """``models/weights/v0.1/vgg.pth`` beside this module (the reference layout)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights", "v0.1", "vgg.pth")


def build_lpips(device, generator: torch.Generator | None = None) -> LPIPS:
    """The frozen float32 LPIPS on ``device``: pretrained weights from
    ``default_weights_path()`` when that file exists, else frozen random
    features (the message says which)."""
    model = LPIPS(generator)
    path = default_weights_path()
    if os.path.exists(path):
        found = load_torch_weights(model, path)
        print(f"LPIPS weights loaded from {path} (vgg features: {found})")
    else:
        print("LPIPS: no pretrained weights found; using frozen random features")
    return model.to(device).eval()
