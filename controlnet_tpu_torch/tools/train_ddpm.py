"""Train the unconditional DDPM UNet.

Counterpart of ``tools/train_ddpm.py``:

    python -m controlnet_tpu_torch.tools.train_ddpm --config config/mnist.yaml \\
        [--images images.npy] [--device cpu]

Images come from the reader ``dataset_params`` names (the MNIST or CIFAR-10
PNG class tree at ``im_path``, decoded on a host thread batch by batch), as
in the JAX tool, or with ``--images`` from an ``.npy`` array of (N, H, W[,
C]) images (uint8, or float in [0, 1]) held on the device.  Adam at ``ddpm_lr``; step-numbered
checkpoints of the whole train state under ``<task_name>/<ddpm_ckpt_name
minus .pth>/`` every ``ckpt_save_every_epochs`` epochs, resumed from the
newest one; at the end the UNet's reference-format ``.pth`` at
``<task_name>/<ddpm_ckpt_name>``, where the reference trainer writes it and
where the ControlNet trainer reads it.  Each epoch's shuffle and noise come
from ``(seed, epoch)``, so a resumed run continues as an unbroken one would.
Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (cpu_state_dict, restore_checkpoint,
                                                save_checkpoint, save_file)
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.train.loops import make_ddpm_train_step
from controlnet_tpu_torch.train.state import create_train_state


def epoch_seeds(seed: int, epoch: int) -> tuple[int, int]:
    """(shuffle seed, generator seed) of one epoch, from the run's seed."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2)
    return int(a), int(b)


def train(config_path: str, images_path: str | None = None, device=None) -> dict:
    """Train to ``num_epochs``; returns {"epochs": [...], "losses": [...]}
    for the epochs this call ran (mean loss of each)."""
    device = resolve_device(device)
    config = cfg.load_config(config_path)
    dp = cfg.diffusion_params(config)
    mp = cfg.model_params(config)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))

    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 device=device)
    torch.manual_seed(seed)
    unet = UNet(mp["im_channels"], mp).to(device)
    state = create_train_state(dict(unet.named_parameters()), tp["ddpm_lr"])

    ckpt_name = tp["ddpm_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, ckpt_name, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree)
        print(f"Resumed from checkpoint at epoch {start_epoch}")

    step = make_ddpm_train_step(unet, sched, compute_dtype=cli.compute_dtype_from(tp))
    source = cli.open_split(config, "train", device, images_path)
    num_epochs = tp["num_epochs"]
    history = {"epochs": [], "losses": []}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for batch, _ in source.batches(tp["batch_size"], shuffle=True, seed=shuffle_seed):
            timer.add(step(state, batch, generator))
        print(f"Finished epoch:{epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            save_checkpoint(task_name, ckpt_name, epoch_idx + 1, state.state_dict(),
                            max_to_keep=cli.ckpt_max_to_keep(tp))
    save_file(cpu_state_dict(unet), os.path.join(task_name, ckpt_name))
    print("Done Training ...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="DDPM training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, H, W[, C]) images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.device)


if __name__ == "__main__":
    main()
