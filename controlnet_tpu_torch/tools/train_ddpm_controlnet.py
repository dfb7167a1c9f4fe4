"""Fine-tune a canny-hint ControlNet on a trained DDPM UNet.

Counterpart of ``tools/train_ddpm_controlnet.py``:

    python -m controlnet_tpu_torch.tools.train_ddpm_controlnet --config config/mnist.yaml \\
        [--hint_backend cv2|tpu] [--images images.npy [--hints hints.npy]] [--device cpu]

Both trunks start from the base UNet's reference-format ``.pth`` at
``<task_name>/<ddpm_ckpt_name>`` (what ``train_ddpm`` writes) through
``ControlNet.init_from_unet``; only the control branch, the hint block and
the zero convs train.  Images come from the reader ``dataset_params`` names,
as in the JAX tool, with hints by ``--hint_backend``: ``cv2`` (the default
there) takes canny on the host in the reader, ``tpu`` (or ``device``) the
port's canny on the card, batch by batch.  With ``--images``, an ``.npy`` of
(N, H, W[, C]) images held on the device, hints come from ``--hints`` ((N,
H, W, 3) in [0, 1], the images' order) or from the port's canny on the
card.  Adam at
``controlnet_lr``; step-numbered checkpoints of the train state plus the
frozen split every ``ckpt_save_every_epochs`` epochs, resumed from the
newest one; at the end the merged ControlNet as a reference-format ``.pth``
at ``<task_name>/<controlnet_ckpt_name>``, which the sampling tool loads.
Runs on the card; ``--device cpu`` runs it on the CPU.  Data-parallel over
N cards, one process each:

    torchrun --nproc_per_node N -m controlnet_tpu_torch.tools.train_ddpm_controlnet \
        --config config/mnist.yaml

Every rank walks the same seeded permutation and keeps its rows of each
global batch of ``batch_size``; the gradients are averaged over the group
(NCCL on the cards, gloo on the CPU), so the run equals one process on the
global batches.  Only rank 0 writes checkpoints, the ``.pth`` and the log;
the others wait at a barrier after each save.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (cpu_state_dict, restore_checkpoint,
                                                save_checkpoint, save_file)
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.ops.canny import canny_hints
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
from controlnet_tpu_torch.train.loops import make_controlnet_train_step
from controlnet_tpu_torch.train.state import TrainState, create_train_state


def device_hints(images: torch.Tensor) -> torch.Tensor:
    """Canny hints of NCHW images in [-1, 1], NCHW (B, 3, H, W) in {0, 1}."""
    return canny_hints(((images + 1.0) / 2.0).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def make_trainer(config: dict, unet_state_dict: dict, device=None,
                 seed: int = 0, mesh=None) -> tuple[ControlNet, TrainState, object]:
    """(ControlNet, train state, step): the model seeded from the base UNet
    with its trunk frozen, Adam at ``controlnet_lr`` (gradients averaged over
    ``mesh``'s group), and the train step of ``train_params`` (compute type,
    ``cfg_drop_prob``)."""
    device = resolve_device(device)
    dp = cfg.diffusion_params(config)
    mp = cfg.model_params(config)
    tp = cfg.train_params(config)
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 device=device)
    torch.manual_seed(seed)
    cn = ControlNet(mp["im_channels"], mp, model_locked=True)
    cn.init_from_unet(unet_state_dict)
    cn.to(device)
    trainable, _ = cn.freeze_trunk()
    state = create_train_state(trainable, tp["controlnet_lr"], mesh=mesh)
    step = make_controlnet_train_step(cn, sched, compute_dtype=cli.compute_dtype_from(tp),
                                      cfg_drop_prob=float(tp.get("cfg_drop_prob", 0.0)))
    return cn, state, step


def train(config_path: str, images_path: str | None = None, hints_path: str | None = None,
          device=None, hint_backend: str | None = None) -> dict:
    """Train to ``controlnet_epochs``; returns {"epochs": [...], "losses":
    [...]} for the epochs this call ran (mean loss of each).  ``hint_backend``
    is ``--hint_backend``'s: cv2 or tpu (None: cv2 for a tree, the
    card for ``.npy`` images)."""
    device = resolve_device(device)
    mesh = cli.mesh_or_none(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    backend = hint_backend or ("cv2" if images_path is None else "tpu")
    if images_path is not None and hints_path is None and backend == "cv2":
        raise ValueError("--hint_backend cv2 takes its hints in the dataset reader: give "
                         "--hints with --images, or read the tree")

    base = load_reference_checkpoint(os.path.join(task_name, tp["ddpm_ckpt_name"]))
    cn, state, step = make_trainer(config, base, device, seed, mesh)
    _, frozen = cn.split_params()

    ckpt_name = tp["controlnet_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, ckpt_name, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree["state"])
        with torch.no_grad():
            for k, p in frozen.items():
                p.copy_(tree["frozen"][k])
        cli.say(mesh, f"Resumed ControlNet from epoch {start_epoch}")
    cli.put_replicated((cn, state.optimizer), mesh)

    source = cli.open_split(config, "train", device, images_path, hints_path,
                            return_hints=backend == "cv2")

    num_epochs = tp["controlnet_epochs"]
    history = {"epochs": [], "losses": []}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for batch, hints in source.batches(tp["batch_size"], shuffle=True, seed=shuffle_seed,
                                           rows=cli.batch_rows(mesh)):
            timer.add(step(state, batch, device_hints(batch) if hints is None else hints,
                           generator))
        cli.say(mesh, f"Finished epoch:{epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            tree = {"state": state.state_dict(),
                    "frozen": {k: p.detach() for k, p in frozen.items()}}
            cli.write_once(mesh, save_checkpoint, task_name, ckpt_name, epoch_idx + 1, tree,
                           max_to_keep=cli.ckpt_max_to_keep(tp))
    cli.write_once(mesh, lambda: save_file(cpu_state_dict(cn), os.path.join(task_name, ckpt_name)))
    cli.say(mesh, "Done Training ...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="DDPM ControlNet training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, H, W[, C]) images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree)")
    parser.add_argument("--hints", default=None,
                        help=".npy of (N, H, W, 3) hints in [0, 1], with --images "
                             "(default: canny on the device)")
    cli.add_hint_backend_arg(parser)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.hints, args.device, args.hint_backend)


if __name__ == "__main__":
    main()
