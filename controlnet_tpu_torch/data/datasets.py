"""Training images from an ``.npy`` array, and seeded batching.

The port reads its dataset from one (N, H, W, C) array (uint8 in [0, 255]
or float in [0, 1]; (N, H, W) is taken as one channel) and maps it to
[-1, 1] as ``controlnet_tpu/data/datasets.py``'s ``_to_unit`` does.
``iterate_batches`` keeps that module's contract: a seeded permutation, the
trailing partial batch dropped, and a dataset smaller than one batch yields
one short batch.  ``load_split`` reads a split with its optional hints (the
distillation tools' train and test splits are two such pairs).

The latent cache: ``load_latents`` merges the ``*.pkl`` shards of the
reference (pickled dicts of torch tensors) and the ``*.npz`` shards that
``tools/infer_vae.py`` writes, each a {key: encoder moments} dict, and
``latents_from_batch`` draws latents from cached moments mean || logvar.
"""

from __future__ import annotations

import glob
import os
import pickle

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


def load_latents(latent_path: str) -> dict[str, np.ndarray]:
    """Every ``*.pkl`` and then every ``*.npz`` shard in ``latent_path``
    merged into one {key: moments} dict, shards in sorted order (a later
    shard's key wins).  Torch tensors become numpy arrays and batched 4-D
    entries are ``[0]``-unwrapped, as the reference's ``v[0]``.  A ``.pkl``
    shard is unpickled: read only caches that you or the reference wrote."""

    def unwrap(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        return arr[0] if arr.ndim == 4 else arr

    latents: dict[str, np.ndarray] = {}
    for f in sorted(glob.glob(os.path.join(latent_path, "*.pkl"))):
        with open(f, "rb") as fh:
            shard = pickle.load(fh)
        for k, v in shard.items():
            latents[k] = unwrap(v)
    for f in sorted(glob.glob(os.path.join(latent_path, "*.npz"))):
        with np.load(f) as shard:
            for k in shard.files:
                latents[k] = unwrap(shard[k])
    return latents


def stack_latents(latents: dict[str, np.ndarray], z_channels: int) -> np.ndarray:
    """The cache's moments in sorted key order as one float32 (N, 2z, h, w)
    array.  Entries are (2z, h, w), as the reference and this package's
    ``infer_vae`` write them; the JAX package's (h, w, 2z) shards are
    transposed."""
    if not latents:
        raise ValueError("the latent cache is empty")
    out = []
    for k in sorted(latents):
        m = np.asarray(latents[k], np.float32)
        if m.ndim != 3 or 2 * z_channels not in (m.shape[0], m.shape[-1]):
            raise ValueError(f"latent {k!r} of shape {m.shape} holds no {2 * z_channels} "
                             "moment channels")
        out.append(m if m.shape[0] == 2 * z_channels else m.transpose(2, 0, 1))
    return np.stack(out)


def latents_from_batch(moments: torch.Tensor, generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """Latents drawn from (B, 2z, h, w) moments mean || logvar: mean +
    exp(logvar / 2) * noise, with standard-normal ``noise`` (the mean's
    shape) from ``generator`` unless injected."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)
