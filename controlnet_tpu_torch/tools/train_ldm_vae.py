"""Train the unconditional latent diffusion model (LDM) UNet.

Counterpart of ``tools/train_ldm_vae.py``:

    python -m controlnet_tpu_torch.tools.train_ldm_vae --config config/celebhq.yaml \\
        [--images images.npy --vae_ckpt vae.pth] [--device cpu]

The latents come from the cache that ``infer_vae`` writes
(``<task_name>/<vae_latent_dir_name>/``, read by ``load_latents`` in sorted
key order and held on the device), each batch drawn from its cached moments;
without a cache, each batch of ``--images`` is encoded on the fly by the
frozen VAE (``--vae_ckpt``, default ``<task_name>/<vae_autoencoder_ckpt_name>``).
The CompVis schedule (``ldm_scheduler``), Adam at ``ldm_lr`` halved at each
epoch of ``ldm_lr_steps`` (counted in updates), the epsilon-MSE step.
Step-numbered checkpoints of the train state every ``ckpt_save_every_epochs``
epochs, resumed from the newest one; each epoch's shuffle and noise come from
``(seed, epoch)``.  At the end the UNet's reference-format ``.pth`` goes to
``<task_name>/<ldm_ckpt_name>``, which ``sample_ldm_vae`` and
``train_ldm_controlnet`` load.  Runs on the card; ``--device cpu`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.data.datasets import (batch_indices, latents_from_batch, load_latents,
                                                stack_latents)
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint, save_file
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.tools.sample_ldm_vae import ldm_schedule, load_vae
from controlnet_tpu_torch.tools.train_ddpm import device_images, epoch_seeds
from controlnet_tpu_torch.train.loops import make_ddpm_train_step
from controlnet_tpu_torch.train.state import create_train_state, multistep_schedule


def cached_moments(config: dict, device) -> torch.Tensor | None:
    """The latent cache's moments (N, 2z, h, w) on ``device`` in sorted key
    order, or None when there is no cache."""
    tp = cfg.train_params(config)
    path = os.path.join(tp["task_name"], tp["vae_latent_dir_name"])
    latents = load_latents(path) if os.path.isdir(path) else {}
    if not latents:
        return None
    z = cfg.autoencoder_params(config)["z_channels"]
    print(f"Found latents for {len(latents)} images")
    return torch.from_numpy(stack_latents(latents, z)).to(device)


class LatentSource:
    """Batches of latents: drawn from cached moments, or encoded on the fly
    by the frozen VAE from images when there is no cache."""

    def __init__(self, config: dict, device, images_path: str | None = None,
                 vae_ckpt: str | None = None):
        self.moments = cached_moments(config, device)
        self.images = self.vae = None
        if self.moments is None:
            if images_path is None:
                raise ValueError("no latent cache; pass --images (and the VAE) to encode "
                                 "latents on the fly")
            print("Loading vae model as latents not present")
            tp = cfg.train_params(config)
            self.vae = load_vae(config, vae_ckpt or os.path.join(
                tp["task_name"], tp["vae_autoencoder_ckpt_name"]), device)
            self.vae.requires_grad_(False)
            self.images = device_images(images_path, device)

    def __len__(self) -> int:
        return len(self.moments if self.moments is not None else self.images)

    def batch(self, idx: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if self.moments is not None:
            return latents_from_batch(self.moments[idx], generator)
        with torch.no_grad():
            return self.vae.encode(self.images[idx], generator)[0]


def make_trainer(config: dict, steps_per_epoch: int, device=None, seed: int = 0):
    """(unet, train state, step): the LDM of ``ldm_params``, Adam at
    ``ldm_lr`` with gamma 0.5 at the ``ldm_lr_steps`` epochs, the step at the
    config's compute type."""
    device = resolve_device(device)
    tp = cfg.train_params(config)
    torch.manual_seed(seed)
    unet = UNet(cfg.autoencoder_params(config)["z_channels"], cfg.ldm_params(config)).to(device)
    schedule = multistep_schedule(tp["ldm_lr"], tp["ldm_lr_steps"], steps_per_epoch, 0.5)
    state = create_train_state(dict(unet.named_parameters()), tp["ldm_lr"],
                               lr_schedule=schedule)
    step = make_ddpm_train_step(unet, ldm_schedule(config, device),
                                compute_dtype=cli.compute_dtype_from(tp))
    return unet, state, step


def train(config_path: str, images_path: str | None = None, vae_ckpt: str | None = None,
          device=None) -> dict:
    """Train to ``ldm_epochs``; returns {"epochs": [...], "losses": [...]}
    for the epochs this call ran (mean loss of each)."""
    device = resolve_device(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    source = LatentSource(config, device, images_path, vae_ckpt)
    batch_size = tp["ldm_batch_size"]
    unet, state, step = make_trainer(config, max(1, len(source) // batch_size), device, seed)

    ckpt_name = tp["ldm_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, ckpt_name, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree)
        print(f"Resumed LDM from epoch {start_epoch}")

    num_epochs = tp["ldm_epochs"]
    history = {"epochs": [], "losses": []}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for idx in batch_indices(len(source), batch_size, shuffle=True, seed=shuffle_seed):
            latents = source.batch(torch.from_numpy(idx).to(device), generator)
            timer.add(step(state, latents, generator))
        print(f"Finished epoch:{epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            save_checkpoint(task_name, ckpt_name, epoch_idx + 1, state.state_dict(),
                            max_to_keep=cli.ckpt_max_to_keep(tp))
    save_file({k: v.detach().cpu() for k, v in unet.state_dict().items()},
              os.path.join(task_name, ckpt_name))
    print("Done Training ...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LDM training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, im_size, im_size, C) images to encode when there is "
                             "no latent cache")
    parser.add_argument("--vae_ckpt", default=None,
                        help="reference-format VAE .pth for on-the-fly encoding "
                             "(default: <task_name>/<vae_autoencoder_ckpt_name>)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.vae_ckpt, args.device)


if __name__ == "__main__":
    main()
