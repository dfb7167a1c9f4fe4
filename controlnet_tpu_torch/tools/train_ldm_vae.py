"""Train the unconditional latent diffusion model (LDM) UNet.

Counterpart of ``tools/train_ldm_vae.py``:

    python -m controlnet_tpu_torch.tools.train_ldm_vae --config config/celebhq.yaml \\
        [--images images.npy --vae_ckpt vae.pth] [--device cpu]

The latents come, as in the JAX tool, from the CelebA-HQ reader on
``dataset_params.im_path`` in latent mode: the cache that ``infer_vae``
writes (``<task_name>/<vae_latent_dir_name>/``) when it holds every image of
the tree, in the tree's order and held on the device, each batch drawn from
its cached moments; else the tree's images, each batch encoded on the fly by
the frozen VAE (``--vae_ckpt``, default
``<task_name>/<vae_autoencoder_ckpt_name>``).  With ``--images`` (an ``.npy``),
or when ``im_path`` is no directory, a cache is read alone in sorted key order
(what ``infer_vae`` writes from an ``.npy``), and without one the ``.npy``'s
images are encoded.
The CompVis schedule (``ldm_scheduler``), Adam at ``ldm_lr`` halved at each
epoch of ``ldm_lr_steps`` (counted in updates), the epsilon-MSE step.
Step-numbered checkpoints of the train state every ``ckpt_save_every_epochs``
epochs, resumed from the newest one; each epoch's shuffle and noise come from
``(seed, epoch)``.  At the end the UNet's reference-format ``.pth`` goes to
``<task_name>/<ldm_ckpt_name>``, which ``sample_ldm_vae`` and
``train_ldm_controlnet`` load.  Runs on the card; ``--device cpu`` runs it on
the CPU.  ``torchrun --nproc_per_node N -m controlnet_tpu_torch.tools.train_ldm_vae``
trains data-parallel, as the JAX tool does on a mesh: each rank takes its
rows of every global batch (of the cache's moments, or of the images, which
it encodes itself), every draw is taken at the global shape and sliced, and
only rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.data.datasets import (CelebDataset, ImageSource, batch_indices,
                                                latents_from_batch, load_latents, stack_latents)
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (cpu_state_dict, restore_checkpoint,
                                                save_checkpoint, save_file)
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.tools.sample_ldm_vae import ldm_schedule, load_vae
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
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


def latent_reader(config: dict, return_hint: bool = False) -> CelebDataset:
    """The CelebA-HQ reader of ``dataset_params`` in latent mode, on the
    cache under ``<task_name>/<vae_latent_dir_name>``."""
    ds, tp = cfg.dataset_params(config), cfg.train_params(config)
    return CelebDataset("train", im_path=ds["im_path"], im_size=ds["im_size"],
                        im_channels=ds["im_channels"], use_latents=True,
                        latent_path=os.path.join(tp["task_name"], tp["vae_latent_dir_name"]),
                        return_hint=return_hint,
                        canny_im_size=ds.get("canny_im_size", 1024))


def reader_moments(dataset: CelebDataset, z_channels: int, device) -> torch.Tensor:
    """A complete latent cache's moments (N, 2z, h, w) on ``device``, in the
    reader's order."""
    ordered = {f"{i:08d}": dataset.latent_maps[name] for i, name in enumerate(dataset.images)}
    return torch.from_numpy(stack_latents(ordered, z_channels)).to(device)


class LatentSource:
    """Batches of latents: drawn from cached moments held on the device, or
    encoded on the fly by the frozen VAE from images (an ``ImageSource``)."""

    def __init__(self, config: dict, device, images_path: str | None = None,
                 vae_ckpt: str | None = None):
        z = cfg.autoencoder_params(config)["z_channels"]
        self.images = self.vae = None
        if images_path is None and os.path.isdir(cfg.dataset_params(config)["im_path"]):
            reader = latent_reader(config)
            self.moments = reader_moments(reader, z, device) if reader.use_latents else None
            if self.moments is None:
                self.images = ImageSource.from_reader(reader, device)
        else:
            self.moments = cached_moments(config, device)
            if self.moments is None:
                if images_path is None:
                    raise ValueError("no latent cache and no image tree; pass --images (and "
                                     "the VAE) to encode latents on the fly")
                self.images = ImageSource.from_npy(images_path, None, device)
        if self.moments is None:
            print("Loading vae model as latents not present")
            tp = cfg.train_params(config)
            self.vae = load_vae(config, vae_ckpt or os.path.join(
                tp["task_name"], tp["vae_autoencoder_ckpt_name"]), device)
            self.vae.requires_grad_(False)

    def __len__(self) -> int:
        return len(self.moments if self.moments is not None else self.images)

    def batches(self, batch_size: int, seed: int, generator: torch.Generator | None,
                mesh=None):
        """One epoch of latent batches in the shuffled order of ``seed``; under
        a data-parallel ``mesh`` this rank's rows of each, their noise drawn
        at the global shape."""
        rows = cli.batch_rows(mesh)
        if self.moments is not None:
            for idx in batch_indices(len(self.moments), batch_size, shuffle=True, seed=seed):
                idx = idx if rows is None else rows(idx)
                yield latents_from_batch(self.moments[torch.from_numpy(idx).to(
                    self.moments.device)], generator, mesh=mesh)
            return
        for images, _ in self.images.batches(batch_size, shuffle=True, seed=seed, rows=rows):
            with torch.no_grad():  # left before the yield: the step takes gradients
                latents = self.vae.encode(images, generator, mesh=mesh)[0]
            yield latents


def make_trainer(config: dict, steps_per_epoch: int, device=None, seed: int = 0, mesh=None):
    """(unet, train state, step): the LDM of ``ldm_params``, Adam at
    ``ldm_lr`` with gamma 0.5 at the ``ldm_lr_steps`` epochs (gradients
    averaged over ``mesh``'s data group), the step at the config's compute
    type."""
    device = resolve_device(device)
    tp = cfg.train_params(config)
    torch.manual_seed(seed)
    unet = UNet(cfg.autoencoder_params(config)["z_channels"], cfg.ldm_params(config)).to(device)
    schedule = multistep_schedule(tp["ldm_lr"], tp["ldm_lr_steps"], steps_per_epoch, 0.5)
    state = create_train_state(dict(unet.named_parameters()), tp["ldm_lr"],
                               lr_schedule=schedule, mesh=mesh)
    step = make_ddpm_train_step(unet, ldm_schedule(config, device),
                                compute_dtype=cli.compute_dtype_from(tp))
    return unet, state, step


def train(config_path: str, images_path: str | None = None, vae_ckpt: str | None = None,
          device=None) -> dict:
    """Train to ``ldm_epochs``; returns {"epochs": [...], "losses": [...]}
    for the epochs this call ran (mean loss of each)."""
    device = resolve_device(device)
    mesh = cli.mesh_or_none(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    source = LatentSource(config, device, images_path, vae_ckpt)
    batch_size = tp["ldm_batch_size"]
    unet, state, step = make_trainer(config, max(1, len(source) // batch_size), device, seed,
                                     mesh)

    ckpt_name = tp["ldm_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, ckpt_name, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree)
        cli.say(mesh, f"Resumed LDM from epoch {start_epoch}")
    cli.put_replicated((unet, state.optimizer), mesh)

    num_epochs = tp["ldm_epochs"]
    history = {"epochs": [], "losses": []}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for latents in source.batches(batch_size, shuffle_seed, generator, mesh):
            timer.add(step(state, latents, generator))
        cli.say(mesh, f"Finished epoch:{epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            cli.write_once(mesh, save_checkpoint, task_name, ckpt_name, epoch_idx + 1,
                           state.state_dict(), max_to_keep=cli.ckpt_max_to_keep(tp))
    cli.write_once(mesh, lambda: save_file(cpu_state_dict(unet),
                                           os.path.join(task_name, ckpt_name)))
    cli.say(mesh, "Done Training ...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LDM training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, im_size, im_size, C) images to encode when there is "
                             "no latent cache (default: the dataset_params tree)")
    parser.add_argument("--vae_ckpt", default=None,
                        help="reference-format VAE .pth for on-the-fly encoding "
                             "(default: <task_name>/<vae_autoencoder_ckpt_name>)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.vae_ckpt, args.device)


if __name__ == "__main__":
    main()
