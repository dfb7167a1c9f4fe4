"""VAE inference: a reconstruction grid, and the latent cache of a dataset.

Counterpart of ``tools/infer_vae.py``:

    python -m controlnet_tpu_torch.tools.infer_vae --config config/celebhq.yaml \\
        --images images.npy [--vae_ckpt vae.pth] [--device cpu]

The VAE comes from a reference-format ``.pth`` (by default
``<task_name>/<vae_autoencoder_ckpt_name>``, what ``train_vae`` writes).
``num_samples`` images picked at random from ``--seed`` and their
reconstructions from the encoder's mean go to
``<task_name>/vae_infer_samples.png``.  With ``train_params.save_latents``
the whole ``.npy`` dataset is encoded in batches of ``--batch_size`` and the
encoder moments mean || logvar, (2z, h, w) each as the reference caches
them, are written as ``latents_{k}.npz`` shards of up to 1,000 entries under
``<task_name>/<vae_latent_dir_name>/``.  The keys are the images' indices,
zero-padded so that sorted keys follow the dataset's order (an ``.npy``
dataset has no file names).  A cache directory that holds anything is left
as it is.  Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.tools.sample_ldm_vae import load_vae
from controlnet_tpu_torch.tools.train_ddpm import device_images

SHARD_SIZE = 1000


def export_latents(vae, images: torch.Tensor, latent_dir: str, batch_size: int = 16) -> int:
    """Write the moments of every image as ``latents_{k}.npz`` shards under
    ``latent_dir``; returns the shard count.  Refuses (returns 0) when the
    directory holds anything."""
    if os.path.exists(latent_dir) and os.listdir(latent_dir):
        print("Latents already present; refusing to overwrite. Delete to regenerate.")
        return 0
    os.makedirs(latent_dir, exist_ok=True)
    shard: dict = {}
    shards = 0
    for start in range(0, len(images), batch_size):
        with torch.no_grad():
            moments = vae.moments(images[start:start + batch_size]).float().cpu().numpy()
        for j, m in enumerate(moments):
            shard[f"{start + j:08d}"] = m  # zero-padded: sorted keys keep the images' order
            if len(shard) == SHARD_SIZE:
                np.savez(os.path.join(latent_dir, f"latents_{shards}.npz"), **shard)
                shard, shards = {}, shards + 1
    if shard:
        np.savez(os.path.join(latent_dir, f"latents_{shards}.npz"), **shard)
        shards += 1
    print(f"Done saving latents of {len(images)} images to {latent_dir} ({shards} shards)")
    return shards


def infer(config_path: str, images_path: str, vae_ckpt: str | None = None, device=None,
          seed: int = 0, batch_size: int = 16) -> None:
    """Write the reconstruction grid and, with ``save_latents``, the latent
    cache of the ``.npy`` dataset."""
    from controlnet_tpu_torch.io.images import save_image_grid

    device = resolve_device(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    z = cfg.autoencoder_params(config)["z_channels"]
    vae = load_vae(config, vae_ckpt or os.path.join(task_name, tp["vae_autoencoder_ckpt_name"]),
                   device)
    images = device_images(images_path, device)
    if len(images) == 0:
        raise ValueError(f"{images_path} holds no images")

    num = tp["num_samples"]
    rng = random.Random(seed)
    idx = torch.tensor([rng.randint(0, len(images) - 1) for _ in range(num)], device=device)
    ims = images[idx]
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
    parser.add_argument("--images", required=True,
                        help=".npy of (N, im_size, im_size, C) images, uint8 or float in [0, 1]")
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
