"""Where the port runs: on the card unless the caller asks for the CPU.

Every entry point resolves its device here, and so passes through
``pin_float32``: float32 means float32 on the card, as in the JAX package.
PyTorch's default runs cuDNN's float32 convolutions in TF32 (10-bit
mantissas); both TF32 switches are turned off on every call, whatever the
device, and no flag turns them back on.
"""

from __future__ import annotations

import torch


def pin_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls.  Only the
    legacy switches are set: reading them after a write through the newer
    ``fp32_precision`` API raises, and callers (``torch.backends.flags``)
    read them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card; with no card that raises rather than quietly
    running on the CPU.  Pass ``device="cpu"`` to run on the CPU.  Pins
    float32 to no TF32 (``pin_float32``) first."""
    pin_float32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
