"""Training images from an ``.npy`` array, and seeded batching.

The port reads its dataset from one (N, H, W, C) array (uint8 in [0, 255]
or float in [0, 1]; (N, H, W) is taken as one channel) and maps it to
[-1, 1] as ``controlnet_tpu/data/datasets.py``'s ``_to_unit`` does.
``iterate_batches`` keeps that module's contract: a seeded permutation, the
trailing partial batch dropped, and a dataset smaller than one batch yields
one short batch.  ``load_split`` reads a split with its optional hints (the
distillation tools' train and test splits are two such pairs).
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


def load_hints(path: str) -> np.ndarray:
    """An ``.npy`` of (N, H, W, C) hints with values in [0, 1] (edge maps,
    any dtype) -> float32."""
    hints = np.asarray(np.load(path), np.float32)
    if hints.ndim != 4:
        raise ValueError(f"{path}: expected (N, H, W, C) hints, got shape {hints.shape}")
    return hints


def load_split(images_path: str, hints_path: str | None, device) -> tuple:
    """One split (train or test) on ``device``: (images float32 NCHW in
    [-1, 1], hints float32 NCHW in [0, 1] or None).  The test split of the
    distillation tools is a second such pair of ``.npy`` files."""
    images = torch.from_numpy(load_images(images_path)).permute(0, 3, 1, 2).contiguous()
    hints = None
    if hints_path is not None:
        hints = torch.from_numpy(load_hints(hints_path)).permute(0, 3, 1, 2).contiguous()
        if hints.shape[0] != images.shape[0] or hints.shape[2:] != images.shape[2:]:
            raise ValueError(f"hints {tuple(hints.shape)} do not match images "
                             f"{tuple(images.shape)}")
        hints = hints.to(device)
    return images.to(device), hints
