"""Training images from an ``.npy`` array, and seeded batching.

The port reads its dataset from one (N, H, W, C) array (uint8 in [0, 255]
or float in [0, 1]; (N, H, W) is taken as one channel) and maps it to
[-1, 1] as ``controlnet_tpu/data/datasets.py``'s ``_to_unit`` does.
``iterate_batches`` keeps that module's contract: a seeded permutation, the
trailing partial batch dropped, and a dataset smaller than one batch yields
one short batch.
"""

from __future__ import annotations

import numpy as np
import torch


def to_unit(images: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] -> float32 [-1, 1]."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    return images.astype(np.float32) * 2.0 - 1.0


def load_images(path: str) -> np.ndarray:
    """An ``.npy`` of (N, H, W[, C]) images -> float32 (N, H, W, C) in [-1, 1]."""
    images = np.load(path)
    if images.ndim == 3:
        images = images[..., None]
    if images.ndim != 4:
        raise ValueError(f"{path}: expected (N, H, W[, C]) images, got shape {images.shape}")
    return to_unit(images)


def batch_indices(n: int, batch_size: int, shuffle: bool = False, seed: int = 0):
    """Index arrays of the batches of one epoch over ``n`` samples."""
    if n == 0:
        return
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    num_batches = n // batch_size
    if num_batches == 0:
        yield order
        return
    for i in range(num_batches):
        yield order[i * batch_size:(i + 1) * batch_size]


def iterate_batches(data, batch_size: int, shuffle: bool = False, seed: int = 0):
    """Batches of ``data`` (a numpy array, or a tensor indexed on its own
    device), in the order of ``batch_indices``."""
    for idx in batch_indices(len(data), batch_size, shuffle, seed):
        if isinstance(data, torch.Tensor):
            yield data[torch.from_numpy(idx).to(data.device)]
        else:
            yield data[idx]
