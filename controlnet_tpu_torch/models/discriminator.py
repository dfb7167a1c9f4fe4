"""PatchGAN discriminator, NCHW.

Port of ``controlnet_tpu/models/discriminator.py``: four 4x4 convs mapping
images to a one-channel grid of patch logits; a bias on the first conv only,
batch norm (batch statistics, ``nn/layers.BatchNorm``) on the middle two,
LeakyReLU(0.2) on all but the last.

State-dict names: the JAX package exports no discriminator, so the names are
chosen in the reference's style, one ``Sequential`` per layer: ``layers.{i}.0``
is the conv and ``layers.{i}.1`` the norm (an empty ``Identity`` on the first
and last layers).  The norm keeps no running statistics, so a reference
``BatchNorm2d`` state dict loads with ``strict=False`` only.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from controlnet_tpu_torch.nn.layers import BatchNorm, Conv2d, Sequential


class Discriminator(nn.Module):
    def __init__(self, im_channels: int = 3, conv_channels: Sequence[int] = (64, 128, 256),
                 kernels: Sequence[int] = (4, 4, 4, 4), strides: Sequence[int] = (2, 2, 2, 1),
                 paddings: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        dims = [im_channels, *conv_channels, 1]
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            Sequential(
                Conv2d(dims[i], dims[i + 1], kernels[i], strides[i], paddings[i], bias=(i == 0)),
                BatchNorm(dims[i + 1]) if 0 < i < n - 1 else nn.Identity(),
                nn.LeakyReLU(0.2) if i < n - 1 else nn.Identity())
            for i in range(n))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """Patch logits.  Under a data-parallel ``mesh`` ``x`` is this rank's
        rows and the batch norms take the global batch's statistics."""
        for conv, norm, act in self.layers:
            x = conv(x)
            x = norm(x, mesh) if isinstance(norm, BatchNorm) else norm(x)
            x = act(x)
        return x
