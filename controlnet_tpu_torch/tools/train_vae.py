"""Train the KL-VAE with LPIPS and PatchGAN adversarial losses.

Counterpart of ``tools/train_vae.py``:

    python -m controlnet_tpu_torch.tools.train_vae --config config/celebhq.yaml \\
        [--images images.npy] [--device cpu]

Images come from the CelebA-HQ reader on ``dataset_params.im_path`` (resized
and center-cropped to ``im_size``, decoded on a host thread batch by batch),
as in the JAX tool, or with ``--images`` from an ``.npy`` array of (N,
im_size, im_size, C) images (uint8, or float in [0, 1]) held on the device.  Two Adams with betas (0.5, 0.999)
at ``autoencoder_lr``, each averaging ``autoencoder_acc_steps`` calls per
update; the discriminator counts after ``disc_start`` steps; LPIPS is frozen
(random features unless ``models/weights/v0.1/vgg.pth`` is present).  An
input / reconstruction grid goes to ``<task_name>/vae_autoencoder_samples/``
at step 1 and every ``autoencoder_img_save_steps`` steps.  Every epoch both
nets' train states are checkpointed under ``<task_name>/<vae_autoencoder_ckpt_name
minus .pth>/`` (the discriminator's also under its own name) and a run
resumes from the newest one, with the step count at ``start_epoch *
steps_per_epoch``; each epoch's shuffle and noise come from ``(seed,
epoch)``, so a resumed run continues as an unbroken one would.  At the end
the VAE's reference-format ``.pth`` goes to
``<task_name>/<vae_autoencoder_ckpt_name>`` (what the latent tools load) and
the discriminator's to ``<task_name>/<vae_discriminator_ckpt_name>``.
Runs on the card; ``--device cpu`` runs it on the CPU.
``torchrun --nproc_per_node N -m controlnet_tpu_torch.tools.train_vae`` trains
data-parallel, as the JAX tool does on a mesh: each rank reads its rows of
every global batch, the VAE's noise is drawn at the global shape, the
discriminator's batch norms take the global batch's statistics, and only
rank 0 writes the grids and the checkpoints.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (cpu_state_dict, restore_checkpoint,
                                                save_checkpoint, save_file)
from controlnet_tpu_torch.models.discriminator import Discriminator
from controlnet_tpu_torch.models.lpips import build_lpips
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
from controlnet_tpu_torch.train.loops import make_vae_gan_train_step
from controlnet_tpu_torch.train.state import create_train_state

BETAS = (0.5, 0.999)


def make_trainer(config: dict, device=None, seed: int = 0, mesh=None):
    """(vae, discriminator, g_state, d_state, step) at the config's widths
    and ``train_params``, weights from ``seed``, gradients averaged over
    ``mesh``'s data group."""
    device = resolve_device(device)
    ds = cfg.dataset_params(config)
    tp = cfg.train_params(config)
    torch.manual_seed(seed)
    vae = VAE(ds["im_channels"], cfg.autoencoder_params(config)).to(device)
    disc = Discriminator(im_channels=ds["im_channels"]).to(device)
    lpips = build_lpips(device, torch.Generator().manual_seed(seed + 1))
    acc = int(tp["autoencoder_acc_steps"])
    g_state = create_train_state(dict(vae.named_parameters()), tp["autoencoder_lr"], BETAS,
                                 acc_steps=acc, mesh=mesh)
    d_state = create_train_state(dict(disc.named_parameters()), tp["autoencoder_lr"], BETAS,
                                 acc_steps=acc, mesh=mesh)
    step = make_vae_gan_train_step(vae, disc, lpips, disc_start=tp["disc_start"],
                                   disc_weight=tp["disc_weight"], kl_weight=tp["kl_weight"],
                                   perceptual_weight=tp["perceptual_weight"],
                                   compute_dtype=cli.compute_dtype_from(tp))
    return vae, disc, g_state, d_state, step


def save_grid(vae: VAE, batch: torch.Tensor, generator: torch.Generator, path: str) -> None:
    """Up to 8 inputs over their reconstructions, as one PNG."""
    from controlnet_tpu_torch.io.images import save_image_grid

    n = min(8, batch.shape[0])
    with torch.no_grad():
        recon = vae(batch[:n], generator)[0].float()
    both = torch.cat([(batch[:n] + 1) / 2, torch.clamp((recon + 1) / 2, 0, 1)])
    save_image_grid(both.permute(0, 2, 3, 1).cpu().numpy(), path, nrow=n)


def train(config_path: str, images_path: str | None = None, device=None) -> dict:
    """Train to ``autoencoder_epochs``; returns {"epochs": [...], "metrics":
    [...]} for the epochs this call ran (the mean of each metric)."""
    from controlnet_tpu_torch.parallel.mesh import gather_rows

    device = resolve_device(device)
    mesh = cli.mesh_or_none(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    vae, disc, g_state, d_state, step = make_trainer(config, device, seed, mesh)

    vae_ckpt, disc_ckpt = tp["vae_autoencoder_ckpt_name"], tp["vae_discriminator_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, vae_ckpt, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        g_state.load_state_dict(tree["g"])
        d_state.load_state_dict(tree["d"])
        cli.say(mesh, f"Resumed VAE training from epoch {start_epoch}")
    # LPIPS is the same on every rank: seeded, or read from the same file
    cli.put_replicated((vae, disc, g_state.optimizer, d_state.optimizer), mesh)

    source = cli.open_split(config, "train", device, images_path, kind="celebhq")
    size = cfg.dataset_params(config)["im_size"]
    if source.images is not None and tuple(source.images.shape[2:]) != (size, size):
        raise ValueError(f"{images_path}: images of {tuple(source.images.shape[2:])}, the "
                         f"config's im_size is {size}")
    batch_size = tp["autoencoder_batch_size"]
    # batches per epoch as iterate_batches yields them (a dataset smaller
    # than one batch yields one short batch)
    steps_per_epoch = max(1, len(source) // batch_size)
    step_count = start_epoch * steps_per_epoch
    save_steps = tp["autoencoder_img_save_steps"]
    grid_dir = os.path.join(task_name, "vae_autoencoder_samples")
    num_epochs = tp["autoencoder_epochs"]
    history = {"epochs": [], "metrics": []}
    for epoch_idx in range(start_epoch, num_epochs):
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        epoch_metrics = []
        for batch, _ in source.batches(batch_size, shuffle=True, seed=shuffle_seed,
                                       rows=cli.batch_rows(mesh)):
            step_count += 1
            if step_count % save_steps == 0 or step_count == 1:
                grid_gen = torch.Generator(device=device).manual_seed(step_count)
                cli.write_once(mesh, save_grid, vae, gather_rows(batch, mesh), grid_gen,
                               os.path.join(grid_dir,
                                            f"current_autoencoder_sample_{step_count}.png"))
            epoch_metrics.append(step(g_state, d_state, batch, step_count, generator))
        means = {k: torch.stack([m[k] for m in epoch_metrics]).mean().item()
                 for k in epoch_metrics[0]}
        cli.say(mesh, f"Finished epoch: {epoch_idx + 1} | Recon Loss : "
                      f"{means['recon_loss']:.4f} | Perceptual Loss : "
                      f"{means['perceptual_loss']:.4f} | G Loss : {means['gen_adv_loss']:.4f} "
                      f"| D Loss {means['disc_loss']:.4f}")
        history["epochs"].append(epoch_idx + 1)
        history["metrics"].append(means)
        keep = cli.ckpt_max_to_keep(tp)
        cli.write_once(mesh, save_checkpoint, task_name, vae_ckpt, epoch_idx + 1,
                       {"g": g_state.state_dict(), "d": d_state.state_dict()}, max_to_keep=keep)
        cli.write_once(mesh, save_checkpoint, task_name, disc_ckpt, epoch_idx + 1,
                       d_state.state_dict(), max_to_keep=keep)
    for model, name in ((vae, vae_ckpt), (disc, disc_ckpt)):
        cli.write_once(mesh, lambda m=model, n=name: save_file(cpu_state_dict(m),
                                                               os.path.join(task_name, n)))
    cli.say(mesh, "Done Training...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="VAE training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, im_size, im_size, C) images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.device)


if __name__ == "__main__":
    main()
