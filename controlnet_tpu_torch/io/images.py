"""PNG image grids (the port's copy of ``controlnet_tpu/io/images.py``) and the
PNG codec of the serve tool's ``/generate`` endpoint.  PIL is imported where
it is used: not every host of the port has it."""

from __future__ import annotations

import io
import os

import numpy as np


def to_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) in [0, 1] -> one (GH, GW, C) uint8 grid."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    rows = (b + nrow - 1) // nrow
    grid = np.ones((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), np.float32)
    for i in range(b):
        r, cl = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + cl * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return (np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """Save a batch (NHWC, [0, 1]) as a PNG grid."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = to_grid(images, nrow=nrow)
    if grid.shape[-1] == 1:
        grid = grid[:, :, 0]
    Image.fromarray(grid).save(path)


def decode_hint_png(raw: bytes, im_size: int, hint_channels: int) -> np.ndarray:
    """PNG (or any format PIL reads) bytes -> one (1, im_size, im_size,
    hint_channels) float32 hint in [0, 1]: converted to grayscale, resized,
    repeated over the hint channels."""
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("L").resize((im_size, im_size))
    hint = np.asarray(img, np.float32) / 255.0
    return np.repeat(hint[None, :, :, None], hint_channels, axis=-1)


def encode_sample_png(sample: np.ndarray) -> bytes:
    """One (H, W, C) sample in [-1, 1] -> PNG bytes (grayscale when C is 1)."""
    from PIL import Image

    out8 = (np.clip((sample + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(out8[:, :, 0] if out8.shape[-1] == 1 else out8).save(buf, format="PNG")
    return buf.getvalue()
