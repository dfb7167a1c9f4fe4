"""Distribution-matching distillation (DMD) of the DDPM ControlNet.

Counterpart of ``tools/train_distribution_matching_controlnet_distilled.py``:

    python -m controlnet_tpu_torch.tools.train_distribution_matching_controlnet_distilled \\
        --config config/mnist.yaml [--images train.npy --test_images test.npy \\
        [--hints h.npy] [--test_hints th.npy]] [--no_plots] [--device cpu]

Images and their cv2 canny hints come from the train and test splits of the
reader ``dataset_params`` names, as in the JAX tool; with ``--images`` and
``--test_images``, from ``.npy`` arrays held on the device, hints from
``--hints`` / ``--test_hints`` or the port's canny on the device.

The optimizer is optax's chain of ``clip_by_global_norm(1.0)`` and AdamW
(weight decay 1e-6) on a cosine schedule from ``distribution_matching_lr``
over ``distribution_matching_epochs`` x steps per epoch
(``train/state.ClippedAdamW``).  A batch with a non-finite loss moves
nothing.  The teacher is the port ControlNet ``.pth`` at
``<task_name>/<controlnet_ckpt_name>``.  Each epoch: the train steps, then the
loss on 5 test batches in float32, then (unless ``--no_plots``, and when PIL
imports) student-vs-teacher x0 grids at t in {50, 200, 500}.  Step-numbered
checkpoints of the train state every epoch, resumed from the newest; a new
best validation loss is saved under its own name, and only after that save
is in place is ``dmd_best_val.json`` written, which a resume reads.  At the
end the student in the reference format (``epoch``, ``model_state_dict``,
``config``) at ``<task_name>/distribution_matching_controlnet_distilled_ckpt.pth``
and the best one at ``..._best_ckpt.pth``; loss curves when matplotlib
imports.  Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint, save_file
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.dmd import DistributionMatchingDistilled
from controlnet_tpu_torch.schedules.linear import add_noise
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints
from controlnet_tpu_torch.train.loops import make_dmd_train_step
from controlnet_tpu_torch.train.state import create_dmd_train_state

CKPT_NAME = "distribution_matching_controlnet_distilled.pth"
BEST_CKPT_NAME = "distribution_matching_controlnet_best.pth"
REF_CKPT = "distribution_matching_controlnet_distilled_ckpt.pth"
BEST_REF_CKPT = "distribution_matching_controlnet_best_ckpt.pth"
BEST_VAL = "dmd_best_val.json"
VAL_BATCHES = 5
GRID_TIMESTEPS = (50, 200, 500)


def make_trainer(config: dict, teacher_state_dict: dict, steps_per_epoch: int, device=None,
                 seed: int = 0):
    """(model, train state, step): the student seeded from ``seed``, the
    teacher from ``teacher_state_dict``, the feature extractor from its own
    seed, and the clipped AdamW on the cosine schedule."""
    device = resolve_device(device)
    mp = cfg.model_params(config)
    tp = cfg.train_params(config)
    torch.manual_seed(seed)
    model = DistributionMatchingDistilled(
        mp["im_channels"], mp, num_timesteps=cfg.diffusion_params(config)["num_timesteps"],
        feature_seed=seed, device=device)
    model.teacher.load_state_dict(teacher_state_dict, strict=True)
    epochs = tp.get("distribution_matching_epochs", 20)
    state = create_dmd_train_state(dict(model.student.named_parameters()),
                                   tp.get("distribution_matching_lr", 5e-5),
                                   epochs * steps_per_epoch)
    step = make_dmd_train_step(model, state, compute_dtype=cli.compute_dtype_from(tp))
    return model, state, step


def reference_checkpoint(student_state_dict: dict, epoch: int, config: dict) -> dict:
    """The reference trainer's ``.pth`` wrapper of the student."""
    return {"epoch": epoch,
            "model_state_dict": {k: v.detach().cpu().clone()
                                 for k, v in student_state_dict.items()},
            "config": config}


@torch.no_grad()
def val_loss(model: DistributionMatchingDistilled, x0: torch.Tensor, hint: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
    """The DMD loss in float32 at uniform timesteps (a device scalar)."""
    sched = model.teacher_schedule
    t = torch.randint(0, sched.num_timesteps, (x0.shape[0],), generator=generator,
                      device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    return model.distillation_loss(add_noise(sched, x0, noise, t), t, hint, x0)[0]


@torch.no_grad()
def predict_pair(model: DistributionMatchingDistilled, x0: torch.Tensor, hint: torch.Tensor,
                 t_value: int, generator: torch.Generator):
    """(student x0, teacher x0) from x0 noised to ``t_value``."""
    t = torch.full((x0.shape[0],), t_value, dtype=torch.int32, device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    x_t = add_noise(model.teacher_schedule, x0, noise, t)
    return model.student(x_t, t, hint), model.teacher_prediction(x_t, t, hint)


def plot_training_curves(history: dict, out_path: str) -> bool:
    """The loss-curve PNG, when matplotlib imports."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib does not import: no training curves")
        return False
    keys = [k for k in history if history[k]]
    if not keys:
        return False
    rows = (len(keys) + 1) // 2
    fig, axes = plt.subplots(rows, 2, figsize=(10, 3 * rows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // 2][i % 2]
        ax.plot(history[k])
        ax.set_title(k)
        ax.set_xlabel("epoch")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return True


def save_grid(model, source, batch_size: int, epoch_idx: int, generator,
              out_dir: str) -> bool:
    """Rows of originals, then student and teacher x0 at each of
    GRID_TIMESTEPS, on up to 4 test images; False when PIL does not import."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    from controlnet_tpu_torch.io.images import save_image_grid

    x0, hint = source.first(min(4, batch_size), seed=epoch_idx)
    hint = device_hints(x0) if hint is None else hint
    nhwc = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()  # noqa: E731
    rows = [(nhwc(x0) + 1) / 2]
    T = model.teacher_schedule.num_timesteps
    for t_value in GRID_TIMESTEPS:
        for pred in predict_pair(model, x0, hint, min(t_value, T - 1), generator):
            rows.append(np.clip((nhwc(pred) + 1) / 2, 0, 1))
    save_image_grid(np.concatenate(rows),
                    os.path.join(out_dir, f"epoch_{epoch_idx + 1:03d}_comparison.png"),
                    nrow=x0.shape[0])
    return True


def train(config_path: str, images_path: str | None = None,
          test_images_path: str | None = None, hints_path: str | None = None,
          test_hints_path: str | None = None, device=None, no_plots: bool = False) -> dict:
    """Train to ``distribution_matching_epochs``; returns the history of the
    epochs this call ran (per-epoch means of each metric, ``val_loss``,
    ``skipped`` batches, ``epochs``) and ``best_val``."""
    device = resolve_device(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    if (images_path is None) != (test_images_path is None):
        raise ValueError("--images and --test_images go together (or neither: the tree)")
    train_src = cli.open_split(config, "train", device, images_path, hints_path,
                               return_hints=True)
    val_src = cli.open_split(config, "test", device, test_images_path, test_hints_path,
                             return_hints=True)
    if len(val_src) == 0:
        raise cfg.ConfigError("DMD training validates (and keeps the best model) on the test "
                              "split every epoch: the test split is empty")
    batch_size = tp["batch_size"]
    teacher = load_reference_checkpoint(os.path.join(task_name, tp["controlnet_ckpt_name"]))
    model, state, step = make_trainer(config, teacher, max(1, len(train_src) // batch_size),
                                      device, seed)

    start_epoch = 0
    restored = restore_checkpoint(task_name, CKPT_NAME, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree["state"])
        print(f"Resumed DMD training from epoch {start_epoch}")
    best_val_path = os.path.join(task_name, BEST_VAL)
    best_val = float("inf")
    if start_epoch > 0 and os.path.exists(best_val_path):
        with open(best_val_path) as f:
            best_val = float(json.load(f)["best_val"])
        print(f"Resumed best val {best_val:.4f}")

    num_epochs = tp.get("distribution_matching_epochs", 20)
    keep = cli.ckpt_max_to_keep(tp)
    history: dict = defaultdict(list)
    for epoch_idx in range(start_epoch, num_epochs):
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        epoch_metrics: list = []
        for x0, hint in train_src.batches(batch_size, shuffle=True, seed=shuffle_seed):
            epoch_metrics.append(step(x0, device_hints(x0) if hint is None else hint, generator))
        # one read of the epoch's device scalars
        means = {k: torch.stack([m[k] for m in epoch_metrics]).float() for k in epoch_metrics[0]}
        skipped = int(means["skipped"].sum().item())
        means = {k: v.mean().item() for k, v in means.items()}

        val = []
        val_batches = val_src.batches(batch_size, shuffle=True, seed=epoch_idx)
        for _, (x0, hint) in zip(range(VAL_BATCHES), val_batches):
            val.append(val_loss(model, x0, device_hints(x0) if hint is None else hint,
                                generator))
        val_batches.close()
        val_mean = torch.stack(val).mean().item()
        for k, v in means.items():
            history[f"train_{k}"].append(v)
        history["val_loss"].append(val_mean)
        history["skipped"].append(skipped)
        history["epochs"].append(epoch_idx + 1)
        print(f"Epoch {epoch_idx + 1}/{num_epochs} | total {means['total_loss']:.4f} "
              f"| dist {means['dist_matching_loss']:.4f} | teacher {means['teacher_loss']:.4f} "
              f"| grad {means['grad_norm']:.3f} | val {val_mean:.4f} | skipped {skipped}")

        if not no_plots:
            save_grid(model, val_src, batch_size, epoch_idx, generator,
                      os.path.join(task_name, "dmd_training_samples"))
        save_checkpoint(task_name, CKPT_NAME, epoch_idx + 1, {"state": state.state_dict()},
                        max_to_keep=keep)
        if val_mean < best_val:
            best_val = val_mean
            # the save is in place (written, then renamed) before the sidecar
            # records it, so a resume never trusts a best that is not on disk
            save_checkpoint(task_name, BEST_CKPT_NAME, epoch_idx + 1,
                            {"state": state.state_dict()}, max_to_keep=keep)
            with open(best_val_path, "w") as f:
                json.dump({"best_val": best_val, "epoch": epoch_idx + 1}, f)
            print(f"New best model (val {best_val:.4f})")

    save_file(reference_checkpoint(model.student.state_dict(), max(num_epochs, start_epoch),
                                   config), os.path.join(task_name, REF_CKPT))
    best = restore_checkpoint(task_name, BEST_CKPT_NAME, map_location="cpu")
    if best is not None:
        save_file(reference_checkpoint(best[0]["state"]["params"], best[1], config),
                  os.path.join(task_name, BEST_REF_CKPT))
    if not no_plots:
        plot_training_curves({k: v for k, v in history.items() if k != "epochs"},
                             os.path.join(task_name, "dmd_training_curves.png"))
    print("DMD distillation training completed!")
    return {**history, "best_val": best_val}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Distribution-matching distillation of the ControlNet (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--images", default=None,
                        help=".npy of (N, H, W[, C]) train images, uint8 or float in [0, 1] "
                             "(default: the dataset_params tree, cv2 hints)")
    parser.add_argument("--hints", default=None,
                        help=".npy of the train hints (default: canny on the device)")
    parser.add_argument("--test_images", default=None,
                        help=".npy of the test split's images (validation, best model), "
                             "with --images")
    parser.add_argument("--test_hints", default=None,
                        help=".npy of the test split's hints (default: canny on the device)")
    parser.add_argument("--no_plots", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if (args.images is None) != (args.test_images is None):
        parser.error("--images and --test_images go together (or neither: the tree)")
    train(args.config_path, args.images, args.test_images, args.hints, args.test_hints,
          args.device, args.no_plots)


if __name__ == "__main__":
    main()
