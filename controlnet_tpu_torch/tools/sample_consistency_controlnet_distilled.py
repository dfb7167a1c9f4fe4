"""Sample from the consistency-distilled ControlNet: 1 step, or ``--num_steps``.

Counterpart of ``tools/sample_consistency_controlnet_distilled.py`` (the same
``--mode`` choices and artifacts):

  * random: N(0, 1) hints, a sample and a hint PNG per sample;
  * test:   hints of the test split (the reader ``dataset_params`` names,
            cv2 hints, as in the JAX tool; or ``--test_images``, with
            ``--test_hints`` or the port's canny on the device), hint /
            original / sample rows;
  * custom: geometric hints (lines, cross, ring, random).

    python -m controlnet_tpu_torch.tools.sample_consistency_controlnet_distilled \\
        --config config/mnist.yaml [--ckpt student.pth] [--mode test [--test_images t.npy]] \\
        [--num_steps 4] [--device cpu]

The student comes from a reference-format ``.pth`` (what the port's trainer or
the JAX package's ``export_torch_checkpoint --type consistency`` writes).
Generation is one batch on the device.  PNGs are written when PIL imports.
Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_student_checkpoint
from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
from controlnet_tpu_torch.tools.train_consistency_controlnet_distilled import CKPT_NAME
from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints


def adapt_hint_channels(hint: np.ndarray, im_channels: int) -> np.ndarray:
    """Match a hint's channels to the image's, for the PNGs."""
    hc = hint.shape[-1]
    if hc == 1 and im_channels == 3:
        return np.repeat(hint, 3, axis=-1)
    if hc == 3 and im_channels == 1:
        return hint.mean(axis=-1, keepdims=True)
    if hc != im_channels:
        first = hint[..., :1]
        return np.repeat(first, im_channels, axis=-1) if im_channels > 1 else first
    return hint


def create_custom_hints(model_config: dict, num_samples: int) -> np.ndarray:
    """Geometric hints: horizontal lines / vertical lines / cross / ring /
    random, in turn."""
    size = model_config["im_size"]
    hc = model_config["hint_channels"]
    hints = np.zeros((num_samples, size, size, hc), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size // 2
    rng = np.random.default_rng(0)
    for i in range(num_samples):
        k = i % 5
        if k == 0:
            hints[i, 8:12, :, :] = 1.0
        elif k == 1:
            hints[i, :, 8:12, :] = 1.0
        elif k == 2:
            hints[i, 8:12, :, :] = 1.0
            hints[i, :, 8:12, :] = 1.0
        elif k == 3:
            dist = np.sqrt((xx - c) ** 2 + (yy - c) ** 2)
            hints[i][(dist >= 8) & (dist <= 12)] = 1.0
        else:
            hints[i] = rng.random((size, size, hc))
    return hints


def load_student(config: dict, ckpt_path: str, device=None) -> ConsistencyDistilled:
    """The student (with its EMA when the checkpoint has one) from a
    reference-format ``.pth``, strictly, without the teacher."""
    device = resolve_device(device)
    mp = cfg.model_params(config)
    model = ConsistencyDistilled(mp["im_channels"], mp, use_ddpm_teacher=False, device=device)
    ckpt = load_student_checkpoint(ckpt_path)
    model.load_student(ckpt["model_state_dict"], ckpt.get("ema_teacher_state_dict"))
    print(f"Loaded consistency student at epoch {ckpt.get('epoch')}")
    return model.eval()


def generate(model: ConsistencyDistilled, hints: torch.Tensor, num_steps: int = 1,
             generator: torch.Generator | None = None, x_start: torch.Tensor | None = None,
             noise=None) -> torch.Tensor:
    """One batch: NCHW hints on the model's device -> NCHW x0; ``x_start``
    and ``noise`` (the noise re-injected after each step but the last)
    replace the draws."""
    shape = (hints.shape[0], model.student.unet.im_channels, hints.shape[2], hints.shape[3])
    with torch.inference_mode():
        return model.generate(hints, shape, generator, num_steps, x_start=x_start, noise=noise)


def pick_hints(mode: str, config: dict, num_samples: int, generator: torch.Generator, device,
               test_images: str | None = None, test_hints: str | None = None, seed: int = 0):
    """(hints NCHW on ``device``, originals NCHW or None) of ``mode``; the
    test mode draws the first shuffled batch of the test split (``.npy``
    arrays when ``test_images`` is given, else the config's reader)."""
    mp = cfg.model_params(config)
    size = mp["im_size"]
    if mode == "random":
        return torch.randn((num_samples, mp["hint_channels"], size, size), generator=generator,
                           device=device), None
    if mode == "custom":
        hints = torch.from_numpy(create_custom_hints(mp, num_samples))
        return hints.permute(0, 3, 1, 2).contiguous().to(device), None
    source = cli.open_split(config, "test", device, test_images, test_hints, return_hints=True)
    ims, hints = source.first(num_samples, seed=seed)
    return (device_hints(ims) if hints is None else hints), ims


def write_pngs(out_dir: str, mode: str, x0: torch.Tensor, hints: torch.Tensor,
               originals: torch.Tensor | None, im_channels: int) -> int:
    """The sample tools' PNGs; returns how many were written (0 without PIL)."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("PIL does not import: no PNGs written")
        return 0
    from controlnet_tpu_torch.io.images import save_image_grid

    nhwc = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()  # noqa: E731
    x0, hints = np.clip((nhwc(x0) + 1) / 2, 0, 1), nhwc(hints)
    if mode == "random":
        hints = np.clip((hints + 1) / 2, 0, 1)
    written = 0
    for i in range(x0.shape[0]):
        hv = adapt_hint_channels(hints[i:i + 1], im_channels)
        if originals is not None:
            row = np.concatenate([hv, (nhwc(originals[i:i + 1]) + 1) / 2, x0[i:i + 1]])
            save_image_grid(row, os.path.join(out_dir, f"test_comparison_{i:03d}.png"), nrow=3)
        else:
            save_image_grid(x0[i:i + 1], os.path.join(out_dir, f"{mode}_sample_{i:03d}.png"),
                            nrow=1)
            save_image_grid(hv, os.path.join(out_dir, f"{mode}_hint_{i:03d}.png"), nrow=1)
        written += 1
    return written


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Sample from the consistency-distilled ControlNet (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--ckpt", default=None,
                        help=f"student .pth (default: <task_name>/{CKPT_NAME})")
    parser.add_argument("--mode", choices=["random", "test", "custom"], default="test")
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--num_steps", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--test_images", default=None,
                        help=".npy of the test split's images (default: the dataset_params "
                             "test split, cv2 hints)")
    parser.add_argument("--test_hints", default=None,
                        help=".npy of the test split's hints (default: canny on the device)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    config = cfg.load_config(args.config_path)
    task_name = cfg.train_params(config)["task_name"]
    model = load_student(config, args.ckpt or os.path.join(task_name, CKPT_NAME), device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    hints, originals = pick_hints(args.mode, config, args.num_samples, generator, device,
                                  args.test_images, args.test_hints, args.seed)
    x0 = generate(model, hints, args.num_steps, generator)
    out_dir = os.path.join(task_name, "consistency_samples")
    written = write_pngs(out_dir, args.mode, x0, hints, originals,
                         cfg.model_params(config)["im_channels"])
    print(f"Inference completed! {x0.shape[0]} samples, {written} PNG sets in {out_dir}")
    return {"x0": x0, "hints": hints}


if __name__ == "__main__":
    main()
