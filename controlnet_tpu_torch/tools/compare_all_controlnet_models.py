"""Four-way comparison: hint and original beside the DDPM ControlNet, the
consistency student and the DMD student.

Counterpart of ``tools/compare_all_controlnet_models.py``: the same flags, a
model whose ``.pth`` is missing is skipped with a message, and with none left
the tool says so and writes nothing.  Artifacts under
``<task_name>/all_model_comparison/``: ``comparison_{i:03d}.png`` rows,
``performance_metrics.txt`` with each model's time and its speed-up against
DDPM, and ``timing_data.npy`` (the timings dict, seconds by model).

    python -m controlnet_tpu_torch.tools.compare_all_controlnet_models \\
        --config config/mnist.yaml [--num_samples 5] [--ddpm_steps 1000] \\
        [--hint_backend cv2|tpu] [--device cpu]

The test batch, the checkpoints, the sampling and the timing are
``compare_controlnet_models``'s; the DMD student generates at t =
``ddpm_steps`` - 1.  Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.tools.compare_controlnet_models import (add_args, draw_test_batch,
                                                                  make_generator, timed,
                                                                  write_grids)

# model -> (the JAX tool's name in its skip message, its timing line's suffix)
MODELS = {"ddpm": ("DDPM ControlNet", "DDPM ControlNet: {s:.3f}s for {n} samples ({T} steps)"),
          "consistency": ("consistency model", "Consistency: {s:.3f}s for {n} samples (1 step)"),
          "dmd": ("DMD model", "DMD: {s:.3f}s for {n} samples (1 step)")}


def compare_models(args) -> dict | None:
    """Returns the timings and the x0 batches (NHWC numpy) of the models
    found, or None when none was."""
    device = resolve_device(args.device)
    config = cfg.load_config(args.config_path)
    im_channels = cfg.model_params(config)["im_channels"]
    task_name = cfg.train_params(config)["task_name"]
    n = args.num_samples
    T = args.ddpm_steps

    images, hints = draw_test_batch(config, n, args.seed, args.hint_backend, device)
    results: dict[str, np.ndarray] = {}
    timings: dict[str, float] = {}
    for model, (label, line) in MODELS.items():
        try:
            generate = make_generator(model, config, hints, T, device)
        except FileNotFoundError as e:
            print(f"Skipping {label}: {e}")
            continue
        timings[model], results[model] = timed(generate, args.seed, device)
        print(line.format(s=timings[model], n=n, T=T))

    if not results:
        print("No model checkpoints found — nothing to compare")
        return None

    out_dir = os.path.join(task_name, "all_model_comparison")
    names = list(results)
    write_grids(out_dir, images, hints, [results[m] for m in names], im_channels)

    lines = ["ALL-MODEL COMPARISON", "=" * 60,
             f"Samples: {n} | DDPM steps: {T}"]
    for m in names:
        lines.append(f"{m}: {timings[m]:.4f}s total, {timings[m] / n:.4f}s/sample")
    if "ddpm" in timings:
        for m in names:
            if m != "ddpm":
                lines.append(f"speedup {m} vs ddpm: {timings['ddpm'] / timings[m]:.1f}x")
    print("\n".join(lines))
    with open(os.path.join(out_dir, "performance_metrics.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    np.save(os.path.join(out_dir, "timing_data.npy"), timings)
    print(f"Results saved to {out_dir}")
    return {"timings": timings, "samples": results}


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser(description="Compare all ControlNet models (PyTorch port)")
    add_args(parser)
    return compare_models(parser.parse_args(argv))


if __name__ == "__main__":
    main()
