#!/usr/bin/env python3
"""Where a sampling step of the PyTorch port goes, on one CUDA card.

Runs the port's sampling tool (controlnet_tpu_torch.tools.
sample_ddpm_controlnet.sample) at full MNIST width, batch 64, over a
20-step schedule: once timed on the host clock (wall ms per step), once
under torch.profiler (device kernel time per step, kernel launches per
step, top kernels).  The device's busy share is device time / wall time.
f32 and bf16 compute.  Weights are the seeded checkpoint of chip_smoke.py.

    python3 scripts/port_profile_step.py [--out build/profile_step.txt]

prints the summary and writes it, with torch.profiler's tables, to --out.
"""

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from controlnet_tpu_torch.schedules.linear import make_linear_schedule  # noqa: E402
from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool  # noqa: E402

STEPS = 20


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    parser = argparse.ArgumentParser(description="profile the port's sampling step")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_step.txt"))
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    report = [f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}"]
    config = chip_smoke.mnist_config()
    ckpt = os.path.join(REPO, "build", "smoke", "mnist_controlnet_seed0.pth")
    chip_smoke.write_seeded_checkpoint(config, ckpt)
    cn, _ = tool.load_model(config, ckpt)
    dp = config["diffusion_params"]
    sched = make_linear_schedule(STEPS, dp["beta_start"], dp["beta_end"], device="cuda")
    hints = chip_smoke.seeded_hints(chip_smoke.BATCH, 28)

    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        tool.sample(cn, sched, hints, compute_dtype=dtype)  # warm-up
        torch.cuda.synchronize()
        start = time.perf_counter()
        tool.sample(cn, sched, hints, compute_dtype=dtype)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / STEPS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tool.sample(cn, sched, hints, compute_dtype=dtype)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
                     for e in kernels) / 1e3 / STEPS
        report.append(
            f"{name}: batch {chip_smoke.BATCH}, {STEPS} steps: wall {wall_ms:.3f} ms/step, "
            f"device kernel time {dev_ms:.3f} ms/step, busy share {dev_ms / wall_ms:.3f}, "
            f"kernel launches {len(kernels) / STEPS:.1f} per step")
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18,
                                          max_name_column_width=60)
        report.append(table)
        top = sorted(prof.key_averages(), key=device_us, reverse=True)[:8]
        report.append("top by device time (ms/step): " + "; ".join(
            f"{e.key[:50]} {device_us(e) / 1e3 / STEPS:.3f}" for e in top))
    text = "\n".join(report)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print("\n".join(line for line in report if not line.startswith(("-", " ", "Name"))
                    and "\n" not in line))


if __name__ == "__main__":
    main()
