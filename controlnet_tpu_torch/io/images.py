"""PNG image grids (the port's copy of ``controlnet_tpu/io/images.py``)."""

from __future__ import annotations

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
