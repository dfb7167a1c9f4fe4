"""Sample from the DMD-distilled ControlNet: x_T ~ N(0, 1), t = T - 1, one
student forward.

Counterpart of ``tools/sample_distribution_matching_controlnet_distilled.py``:

  * test:   hints of the test split (the reader ``dataset_params`` names,
            cv2 hints, as in the JAX tool; or ``--test_images``, with
            ``--test_hints`` or the port's canny on the device), hint /
            sample / original rows;
  * random: N(0, 1) hints, hint / sample pairs;
  * custom: geometric hints (stripes, vertical stripes, diagonal, disk).

    python -m controlnet_tpu_torch.tools.sample_distribution_matching_controlnet_distilled \\
        --config config/mnist.yaml [--ckpt student.pth | --use_best] [--mode custom] \\
        [--device cpu]

The student comes from a reference-format ``.pth`` (what the port's trainer
or the JAX package's ``export_torch_checkpoint --type dmd`` writes);
``--use_best`` takes the best-validation one the trainer wrote, or the last
one when there is none.  PNGs are written when PIL imports.  Runs on the
card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_student_checkpoint
from controlnet_tpu_torch.models.dmd import DistributionMatchingControlNet
from controlnet_tpu_torch.tools.sample_consistency_controlnet_distilled import (pick_hints,
                                                                               write_pngs)
from controlnet_tpu_torch.tools.train_distribution_matching_controlnet_distilled import (
    BEST_REF_CKPT, REF_CKPT)


def create_geometric_hints(num_samples: int, model_config: dict) -> np.ndarray:
    """Horizontal stripes / vertical stripes / diagonal / disk, in turn."""
    size = model_config["im_size"]
    hc = model_config["hint_channels"]
    hints = np.zeros((num_samples, size, size, hc), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    c, r = size // 2, size // 4
    for i in range(num_samples):
        k = i % 4
        if k == 0:
            hints[i, ::4, :, :] = 1.0
        elif k == 1:
            hints[i, :, ::4, :] = 1.0
        elif k == 2:
            hints[i][yy == xx] = 1.0
        else:
            hints[i][(xx - c) ** 2 + (yy - c) ** 2 <= r * r] = 1.0
    return hints


def default_ckpt(task_name: str, use_best: bool) -> str:
    best = os.path.join(task_name, BEST_REF_CKPT)
    return best if use_best and os.path.exists(best) else os.path.join(task_name, REF_CKPT)


def load_student(config: dict, ckpt_path: str, device=None) -> DistributionMatchingControlNet:
    """The student from a reference-format ``.pth``, strictly."""
    device = resolve_device(device)
    mp = cfg.model_params(config)
    student = DistributionMatchingControlNet(mp["im_channels"], mp)
    ckpt = load_student_checkpoint(ckpt_path)
    student.load_state_dict(ckpt["model_state_dict"], strict=True)
    print(f"Loaded DMD student at epoch {ckpt.get('epoch')}")
    return student.to(device).eval()


def generate(student: DistributionMatchingControlNet, hints: torch.Tensor, num_timesteps: int,
             generator: torch.Generator | None = None,
             x_start: torch.Tensor | None = None) -> torch.Tensor:
    """One forward at t = T - 1 from x_T ~ N(0, 1) (or ``x_start``): NCHW
    hints -> NCHW x0."""
    b = hints.shape[0]
    shape = (b, student.unet.im_channels, hints.shape[2], hints.shape[3])
    x_t = x_start if x_start is not None else torch.randn(shape, generator=generator,
                                                          device=hints.device)
    t = torch.full((b,), num_timesteps - 1, dtype=torch.int32, device=hints.device)
    with torch.inference_mode():
        return student(x_t, t, hints)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Sample from the DMD-distilled ControlNet (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--ckpt", default=None, help=f"student .pth (default: <task_name>/"
                                                     f"{REF_CKPT})")
    parser.add_argument("--use_best", "--best", dest="use_best", action="store_true",
                        help=f"load <task_name>/{BEST_REF_CKPT} (the best validation loss)")
    parser.add_argument("--mode", choices=["test", "random", "custom"], default="test")
    parser.add_argument("--num_samples", type=int, default=10)
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
    mp = cfg.model_params(config)
    student = load_student(config, args.ckpt or default_ckpt(task_name, args.use_best), device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.mode == "custom":
        hints = torch.from_numpy(create_geometric_hints(args.num_samples, mp))
        hints, originals = hints.permute(0, 3, 1, 2).contiguous().to(device), None
    else:
        hints, originals = pick_hints(args.mode, config, args.num_samples, generator, device,
                                      args.test_images, args.test_hints, args.seed)
    x0 = generate(student, hints, cfg.diffusion_params(config)["num_timesteps"], generator)
    out_dir = os.path.join(task_name, "distribution_matching_samples")
    written = write_pngs(out_dir, args.mode, x0, hints, originals, mp["im_channels"])
    print(f"Inference completed! {x0.shape[0]} samples, {written} PNG sets in {out_dir}")
    return {"x0": x0, "hints": hints}


if __name__ == "__main__":
    main()
