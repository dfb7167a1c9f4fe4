"""Compare the DDPM ControlNet (``--ddpm_steps`` ancestral steps) with the
consistency-distilled student (1 step).

Counterpart of ``tools/compare_controlnet_models.py``: the same flags
(``--config``, ``--num_samples``, ``--ddpm_steps``, ``--seed``) and the same
artifacts under ``<task_name>/model_comparison/``: ``comparison_{i:03d}.png``
rows of hint, original, DDPM and consistency samples, ``performance_metrics.txt``
and ``timing_data.npy`` (a pickled dict).

    python -m controlnet_tpu_torch.tools.compare_controlnet_models \\
        --config config/mnist.yaml [--num_samples 5] [--ddpm_steps 1000] \\
        [--hint_backend cv2|tpu] [--device cpu]

The models come from the reference-format ``.pth`` files the port's trainers
write: ``<task_name>/<controlnet_ckpt_name>`` and
``<task_name>/consistency_controlnet_distilled.pth``.  The test batch is the
first shuffled batch of the test split from ``--seed``, as the JAX tool draws
it; its hints are cv2's canny in the reader (the JAX tool's) or, with
``--hint_backend tpu``, the port's canny on the card.  The DDPM schedule has
``--ddpm_steps`` steps (not the config's ``num_timesteps``), the hint
features are computed once, and only x0 is kept.  Each model is timed after
one warm-up call (which also builds the kernels on first use): the wall clock
around one call that ends in a synchronise on the card.  The sampling code
here is shared with ``compare_all_controlnet_models``.  Runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.data.datasets import iterate_batches
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.tools import sample_consistency_controlnet_distilled as cd_sample
from controlnet_tpu_torch.tools import sample_ddpm_controlnet as ddpm_sample
from controlnet_tpu_torch.tools import (
    sample_distribution_matching_controlnet_distilled as dmd_sample)
from controlnet_tpu_torch.tools.train_consistency_controlnet_distilled import CKPT_NAME
from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints


def draw_test_batch(config: dict, n: int, seed: int, hint_backend: str | None,
                    device) -> tuple[np.ndarray, np.ndarray]:
    """(images, hints), NHWC float32: the first shuffled batch of ``n`` test
    images (``next(iterate_batches(reader, n, shuffle=True, seed))``), with
    cv2 hints from the reader, or with ``hint_backend`` tpu the port's canny
    of the same images on ``device``."""
    on_device = hint_backend == "tpu"
    reader = cli.build_dataset(cfg.train_params(config)["task_name"],
                               cfg.dataset_params(config), "test", return_hints=not on_device)
    batches = iterate_batches(reader, n, shuffle=True, seed=seed)
    try:
        batch = next(batches)
    finally:
        batches.close()
    if not on_device:
        return batch
    nchw = torch.from_numpy(batch).permute(0, 3, 1, 2).to(device)
    return batch, device_hints(nchw).permute(0, 2, 3, 1).float().cpu().numpy()


def checkpoint_path(config: dict, model: str) -> str:
    """Where the port's trainer writes ``model``'s reference-format ``.pth``."""
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    if model == "ddpm":
        return os.path.join(task_name, tp["controlnet_ckpt_name"])
    if model == "consistency":
        return os.path.join(task_name, CKPT_NAME)
    if model == "dmd":
        return dmd_sample.default_ckpt(task_name, use_best=False)
    raise ValueError(f"unknown model {model!r}")


def make_generator(model: str, config: dict, hints: np.ndarray, ddpm_steps: int, device):
    """Load ``model`` ("ddpm", "consistency" or "dmd") from its ``.pth``
    (FileNotFoundError when there is none) and return ``generate(seed, *,
    x_start=None, step_noise=None)``: one batch of x0 (NCHW, on ``device``)
    for the (B, H, W, 3) ``hints``, its noise from a generator seeded with
    ``seed`` unless injected.  "ddpm" runs the ancestral loop on a
    ``ddpm_steps``-step schedule over hint features computed here, once;
    the students take one forward, the DMD student at t = ddpm_steps - 1."""
    path = checkpoint_path(config, model)
    if model == "ddpm":
        cn, _ = ddpm_sample.load_model(config, path, device)
        dp = cfg.diffusion_params(config)
        sched = make_linear_schedule(ddpm_steps, dp["beta_start"], dp["beta_end"], device=device)
        loop, hint_arg, _ = ddpm_sample.prepare(cn, sched, hints, record_every=ddpm_steps)

        def generate(seed: int, **noise) -> torch.Tensor:
            return loop(cn, torch.Generator(device=device).manual_seed(seed), hint_arg,
                        **noise)[0]

        return generate
    hint = torch.from_numpy(np.ascontiguousarray(hints, np.float32)).permute(0, 3, 1, 2)
    hint = hint.contiguous().to(device)
    if model == "consistency":
        student = cd_sample.load_student(config, path, device)

        def generate(seed: int, x_start: torch.Tensor | None = None) -> torch.Tensor:
            return cd_sample.generate(student, hint, 1,
                                      torch.Generator(device=device).manual_seed(seed),
                                      x_start=x_start)

        return generate
    student = dmd_sample.load_student(config, path, device)

    def generate(seed: int, x_start: torch.Tensor | None = None) -> torch.Tensor:
        return dmd_sample.generate(student, hint, ddpm_steps,
                                   torch.Generator(device=device).manual_seed(seed),
                                   x_start=x_start)

    return generate


def timed(generate, seed: int, device) -> tuple[float, np.ndarray]:
    """One warm-up call, then (seconds, NHWC x0) of one call on the wall
    clock, ended by a synchronise on the card."""
    generate(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.time()
    x0 = generate(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.time() - start
    return seconds, x0.float().permute(0, 2, 3, 1).cpu().numpy()


def write_grids(out_dir: str, images: np.ndarray, hints: np.ndarray, samples: list,
                im_channels: int) -> None:
    """``comparison_{i:03d}.png``: one row per sample of its hint, the
    original and each model's x0."""
    from controlnet_tpu_torch.io.images import save_image_grid

    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(images)):
        row = [cd_sample.adapt_hint_channels(hints[i:i + 1], im_channels),
               (images[i:i + 1] + 1) / 2]
        row += [np.clip((x0[i:i + 1] + 1) / 2, 0, 1) for x0 in samples]
        save_image_grid(np.concatenate(row), os.path.join(out_dir, f"comparison_{i:03d}.png"),
                        nrow=len(row))


def add_args(parser) -> None:
    """The flags both compare tools take."""
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml", type=str)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--ddpm_steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    cli.add_hint_backend_arg(parser)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")


def compare_models(args) -> dict:
    """Returns the timings and the x0 batches (NHWC numpy) of both models."""
    device = resolve_device(args.device)
    config = cfg.load_config(args.config_path)
    im_channels = cfg.model_params(config)["im_channels"]
    task_name = cfg.train_params(config)["task_name"]
    n = args.num_samples
    T = args.ddpm_steps

    images, hints = draw_test_batch(config, n, args.seed, args.hint_backend, device)
    ddpm = make_generator("ddpm", config, hints, T, device)
    cons = make_generator("consistency", config, hints, T, device)
    ddpm_time, ddpm_x0 = timed(ddpm, args.seed, device)
    cons_time, cons_x0 = timed(cons, args.seed, device)

    out_dir = os.path.join(task_name, "model_comparison")
    write_grids(out_dir, images, hints, [ddpm_x0, cons_x0], im_channels)

    ddpm_avg = ddpm_time / n
    cons_avg = cons_time / n
    speedup = ddpm_avg / cons_avg if cons_avg > 0 else float("inf")
    lines = [
        "PERFORMANCE COMPARISON: DDPM vs CONSISTENCY MODEL",
        "=" * 60,
        f"Samples generated: {n}",
        f"DDPM steps: {T}   Consistency steps: 1",
        f"DDPM total time: {ddpm_time:.4f}s  ({ddpm_avg:.4f}s/sample)",
        f"Consistency total time: {cons_time:.4f}s  ({cons_avg:.4f}s/sample)",
        f"Speedup: {speedup:.1f}x",
        f"Theoretical speedup (steps ratio): {T:.0f}x",
    ]
    print("\n".join(lines))
    with open(os.path.join(out_dir, "performance_metrics.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    timings = {"ddpm_times": [ddpm_avg] * n, "consistency_times": [cons_avg] * n,
               "ddpm_total": ddpm_time, "consistency_total": cons_time, "speedup": speedup}
    np.save(os.path.join(out_dir, "timing_data.npy"), timings)
    print(f"Results saved to {out_dir}")
    return {"timings": timings, "samples": {"ddpm": ddpm_x0, "consistency": cons_x0}}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Compare ControlNet models (PyTorch port)")
    add_args(parser)
    return compare_models(parser.parse_args(argv))


if __name__ == "__main__":
    main()
