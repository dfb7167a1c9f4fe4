"""Consistency-distil the DDPM ControlNet into a 1-step sampler.

Counterpart of ``tools/train_consistency_controlnet_distilled.py``:

    python -m controlnet_tpu_torch.tools.train_consistency_controlnet_distilled \\
        --config config/mnist.yaml [--images images.npy [--hints hints.npy]] [--device cpu]

The mode comes from ``train_params``: ``use_consistency_only`` (the EMA
target alone), else ``use_ddpm_distillation`` (default true: log-uniform
sigma, alpha * recon + (1 - alpha) * teacher MSE), else ``manual``
(high-noise-biased timesteps).  The teacher is the port ControlNet's
reference-format ``.pth`` at ``<task_name>/<controlnet_ckpt_name>`` (what
``train_ddpm_controlnet`` writes); ``consistency_only`` needs none.  Adam at
``consistency_lr``; alpha stays 0.5 as in the reference trainer.  Images and
their cv2 canny hints come from the train split of the reader
``dataset_params`` names, as in the JAX tool; with ``--images``, from an
``.npy`` held on the device, hints from ``--hints`` or the port's canny on
the device.  Step-numbered checkpoints of {state, ema} every
``ckpt_save_every_epochs`` epochs, written in the background while training
goes on (``save_checkpoint_background``; waited for before the end), resumed
from the newest; at the end the
student in the reference format (``epoch``, ``model_state_dict``,
``ema_teacher_state_dict``, ``model_config``) at
``<task_name>/consistency_controlnet_distilled.pth``, which the sample tool
and the serve tool load.  Runs on the card; ``--device cpu`` runs it on the
CPU.  ``torchrun --nproc_per_node N -m
controlnet_tpu_torch.tools.train_consistency_controlnet_distilled`` trains
data-parallel as ``train_ddpm_controlnet`` does; the EMA stays in step on
every rank, as the averaged gradient is the same on each.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (restore_checkpoint, save_checkpoint_background,
                                                save_file, wait_for_checkpoints)
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints
from controlnet_tpu_torch.train.loops import make_consistency_train_step
from controlnet_tpu_torch.train.state import TrainState, create_train_state

CKPT_NAME = "consistency_controlnet_distilled.pth"


def mode_from(train_config: dict) -> str:
    if train_config.get("use_consistency_only", False):
        return "consistency_only"
    if train_config.get("use_ddpm_distillation", True):
        return "ddpm_distillation"
    return "manual"


def make_trainer(config: dict, teacher_state_dict: dict | None, device=None, seed: int = 0,
                 mesh=None):
    """(model, train state, step, mode): the student seeded from ``seed``, its
    EMA a copy, the teacher from ``teacher_state_dict`` (None in
    ``consistency_only``), Adam at ``consistency_lr`` (gradients averaged over
    ``mesh``'s group)."""
    device = resolve_device(device)
    mp = cfg.model_params(config)
    tp = cfg.train_params(config)
    mode = mode_from(tp)
    torch.manual_seed(seed)
    model = ConsistencyDistilled(mp["im_channels"], mp,
                                 use_ddpm_teacher=mode != "consistency_only",
                                 num_timesteps=cfg.diffusion_params(config)["num_timesteps"],
                                 device=device)
    if mode != "consistency_only":
        if teacher_state_dict is None:
            raise ValueError(f"mode {mode!r} needs the ControlNet teacher's weights")
        model.teacher.load_state_dict(teacher_state_dict, strict=True)
    state = create_train_state(dict(model.student.named_parameters()),
                               tp.get("consistency_lr", 1e-4), mesh=mesh)
    step = make_consistency_train_step(model, state, mode=mode, total_epochs=None,
                                       compute_dtype=cli.compute_dtype_from(tp))
    return model, state, step, mode


def reference_checkpoint(model: ConsistencyDistilled, epoch: int, model_config: dict) -> dict:
    """The reference trainer's ``.pth`` wrapper of the student and its EMA."""
    cpu = lambda m: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}  # noqa: E731
    return {"epoch": epoch, "model_state_dict": cpu(model.student),
            "ema_teacher_state_dict": cpu(model.ema_teacher), "model_config": dict(model_config)}


def restore(task_name: str, state: TrainState, model: ConsistencyDistilled, device) -> int:
    """Resume from the newest {state, ema} checkpoint; returns its epoch (0
    when there is none).  Every rank restores the same one."""
    restored = restore_checkpoint(task_name, CKPT_NAME, map_location=device)
    if restored is None:
        return 0
    tree, epoch = restored
    state.load_state_dict(tree["state"])
    model.ema_teacher.load_state_dict(tree["ema"], strict=True)
    cli.say(state.mesh, f"Resumed consistency training from epoch {epoch}")
    return epoch


def train(config_path: str, images_path: str | None = None, hints_path: str | None = None,
          device=None) -> dict:
    """Train to ``consistency_epochs``; returns {"epochs", "losses", "mode"}
    for the epochs this call ran (mean loss of each)."""
    device = resolve_device(device)
    mesh = cli.mesh_or_none(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    teacher = None
    if mode_from(tp) != "consistency_only":
        teacher = load_reference_checkpoint(os.path.join(task_name, tp["controlnet_ckpt_name"]))
    model, state, step, mode = make_trainer(config, teacher, device, seed, mesh)
    cli.say(mesh, f"Consistency training mode: {mode}")
    start_epoch = restore(task_name, state, model, device)
    cli.put_replicated((model, state.optimizer), mesh)

    source = cli.open_split(config, "train", device, images_path, hints_path, return_hints=True)
    num_epochs = tp.get("consistency_epochs", 10)
    history = {"epochs": [], "losses": [], "mode": mode}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for batch, hints in source.batches(tp["batch_size"], shuffle=True, seed=shuffle_seed,
                                           rows=cli.batch_rows(mesh)):
            metrics = step(batch, device_hints(batch) if hints is None else hints, generator,
                           epoch_idx)
            timer.add(metrics.get("total_loss", metrics.get("consistency_loss")))
        cli.say(mesh, f"Epoch {epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            tree = {"state": state.state_dict(),
                    "ema": {k: v.detach() for k, v in model.ema_teacher.state_dict().items()}}
            cli.write_once(mesh, save_checkpoint_background, task_name, CKPT_NAME,
                           epoch_idx + 1, tree, max_to_keep=cli.ckpt_max_to_keep(tp))
    cli.write_once(mesh, wait_for_checkpoints)
    cli.write_once(mesh, lambda: save_file(
        reference_checkpoint(model, max(num_epochs, start_epoch), cfg.model_params(config)),
        os.path.join(task_name, CKPT_NAME)))
    cli.say(mesh, "Distillation training completed!")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Consistency distillation of the ControlNet (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, H, W[, C]) images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree, cv2 hints)")
    parser.add_argument("--hints", default=None,
                        help=".npy of (N, H, W, 3) hints in [0, 1], with --images "
                             "(default: canny on the device)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.images, args.hints, args.device)


if __name__ == "__main__":
    main()
