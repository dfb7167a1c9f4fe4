"""VAE inference: a reconstruction grid, and the latent cache of a dataset.

Counterpart of ``tools/infer_vae.py``:

    python -m controlnet_tpu_torch.tools.infer_vae --config config/celebhq.yaml \\
        [--images images.npy] [--vae_ckpt vae.pth] [--device cpu]

The VAE comes from a reference-format ``.pth`` (by default
``<task_name>/<vae_autoencoder_ckpt_name>``, what ``train_vae`` writes).
``num_samples`` images picked at random from ``--seed`` and their
reconstructions from the encoder's mean go to
``<task_name>/vae_infer_samples.png``.  The images come from the CelebA-HQ
reader on ``dataset_params.im_path``, as in the JAX tool, or with
``--images`` from an ``.npy``.  With ``train_params.save_latents`` the whole
dataset is encoded in batches of ``--batch_size`` and the encoder moments
mean || logvar, (2z, h, w) each as the reference caches them, are written as
``latents_{k}.npz`` shards of up to 1,000 entries under
``<task_name>/<vae_latent_dir_name>/``.  The keys of a tree's images are
their basenames, as the JAX tool keys them (a cache written by either tool
reads on the other's ``CelebDataset``); an ``.npy`` dataset has no file
names, so its keys are the images' indices, zero-padded so that sorted keys
follow the dataset's order.  A cache directory that holds anything is left
as it is.  Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.tools.sample_ldm_vae import load_vae

SHARD_SIZE = 1000


def _stack(images, start: int, stop: int, device) -> torch.Tensor:
    """Images ``start:stop`` as NCHW on ``device``: a slice of a tensor, or
    the items of a reader stacked."""
    if isinstance(images, torch.Tensor):
        return images[start:stop]
    batch = np.stack([images[i] for i in range(start, stop)])
    return torch.from_numpy(batch).permute(0, 3, 1, 2).contiguous().to(device)


def export_latents(vae, images, latent_dir: str, batch_size: int = 16) -> int:
    """Write the moments of every image as ``latents_{k}.npz`` shards under
    ``latent_dir``; returns the shard count.  ``images`` is an NCHW tensor
    (keys: zero-padded indices) or a CelebA-HQ reader (keys: its basenames,
    ``images.images``).  Refuses (returns 0) when the directory holds
    anything."""
    if os.path.exists(latent_dir) and os.listdir(latent_dir):
        print("Latents already present; refusing to overwrite. Delete to regenerate.")
        return 0
    os.makedirs(latent_dir, exist_ok=True)
    device = next(vae.parameters()).device
    # zero-padded indices: sorted keys keep an .npy dataset's order
    keys = (images.images if not isinstance(images, torch.Tensor)
            else [f"{i:08d}" for i in range(len(images))])
    shard: dict = {}
    shards = 0
    for start in range(0, len(images), batch_size):
        batch = _stack(images, start, min(start + batch_size, len(images)), device)
        with torch.no_grad():
            moments = vae.moments(batch).float().cpu().numpy()
        for j, m in enumerate(moments):
            shard[keys[start + j]] = m
            if len(shard) == SHARD_SIZE:
                np.savez(os.path.join(latent_dir, f"latents_{shards}.npz"), **shard)
                shard, shards = {}, shards + 1
    if shard:
        np.savez(os.path.join(latent_dir, f"latents_{shards}.npz"), **shard)
        shards += 1
    print(f"Done saving latents of {len(images)} images to {latent_dir} ({shards} shards)")
    return shards


def infer(config_path: str, images_path: str | None = None, vae_ckpt: str | None = None,
          device=None, seed: int = 0, batch_size: int = 16) -> None:
    """Write the reconstruction grid and, with ``save_latents``, the latent
    cache of the dataset (the tree, or the ``.npy`` at ``images_path``)."""
    from controlnet_tpu_torch.io.images import save_image_grid

    device = resolve_device(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    z = cfg.autoencoder_params(config)["z_channels"]
    vae = load_vae(config, vae_ckpt or os.path.join(task_name, tp["vae_autoencoder_ckpt_name"]),
                   device)
    source = cli.open_split(config, "train", device, images_path, kind="celebhq")
    images = source.images if source.dataset is None else source.dataset
    if len(images) == 0:
        raise ValueError(f"{images_path or cfg.dataset_params(config)['im_path']} holds no "
                         "images")

    num = tp["num_samples"]
    rng = random.Random(seed)
    idxs = [rng.randint(0, len(images) - 1) for _ in range(num)]
    ims = torch.cat([_stack(images, i, i + 1, device) for i in idxs])
    with torch.no_grad():
        recon = vae.decode(vae.moments(ims)[:, :z]).float()
    both = torch.cat([(ims + 1) / 2, torch.clamp((recon + 1) / 2, 0, 1)])
    out = os.path.join(task_name, "vae_infer_samples.png")
    save_image_grid(both.permute(0, 2, 3, 1).cpu().numpy(), out, nrow=num)
    print(f"Wrote reconstruction grid to {out}")

    if tp.get("save_latents", False):
        export_latents(vae, images, os.path.join(task_name, tp["vae_latent_dir_name"]),
                       batch_size)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="VAE inference and latent export (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, im_size, im_size, C) images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree)")
    parser.add_argument("--vae_ckpt", default=None,
                        help="reference-format VAE .pth "
                             "(default: <task_name>/<vae_autoencoder_ckpt_name>)")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    infer(args.config_path, args.images, args.vae_ckpt, args.device, args.seed, args.batch_size)


if __name__ == "__main__":
    main()
