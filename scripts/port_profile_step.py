#!/usr/bin/env python3
"""Where a sampling step of the PyTorch port goes, on one CUDA card.

Runs the port's ancestral sampling loop over a 20-step schedule: once timed
on the host clock (wall ms per step), once under torch.profiler (device
kernel time per step, kernel launches per step, top kernels).  The device's
busy share is device time / wall time.  f32 and bf16 compute.  Weights are
the seeded checkpoints of chip_smoke.py.

``--config mnist`` (the default) is the DDPM ControlNet at full MNIST width,
batch 64, through its sample tool.  ``--config celebhq`` is the latent
ControlNet at the full width of config/celebhq.yaml, batch 16, 32x32x4
latents: the denoising loop alone, with the hint features (1024^2 hints)
encoded before the window and no VAE decode in it.

    python3 scripts/port_profile_step.py [--config celebhq] [--out build/profile_step.txt]

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


def mnist_runner():
    """(run(compute_dtype), batch): the MNIST sample tool over STEPS steps."""
    config = chip_smoke.mnist_config()
    ckpt = os.path.join(REPO, "build", "smoke", "mnist_controlnet_seed0.pth")
    chip_smoke.write_seeded_checkpoint(config, ckpt)
    cn, _ = tool.load_model(config, ckpt)
    dp = config["diffusion_params"]
    sched = make_linear_schedule(STEPS, dp["beta_start"], dp["beta_end"], device="cuda")
    hints = chip_smoke.seeded_hints(chip_smoke.BATCH, 28)
    return (lambda dtype: tool.sample(cn, sched, hints, compute_dtype=dtype)), chip_smoke.BATCH


def celebhq_runner():
    """(run(compute_dtype), batch): the latent ControlNet's denoising loop
    over STEPS steps, hint features encoded once beforehand."""
    from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as ldm_tool

    config = chip_smoke.celebhq_config()
    work = os.path.join(REPO, "build", "smoke", "ldm")
    cn_path = os.path.join(work, "ldm_controlnet_seed0.pth")
    vae_path = os.path.join(work, "vae_seed0.pth")
    chip_smoke.write_seeded_ldm_checkpoints(config, cn_path, vae_path)
    cn, _, _ = ldm_tool.load_models(config, cn_path, vae_path)
    dp, ds = config["diffusion_params"], config["dataset_params"]
    sched = make_linear_schedule(STEPS, dp["beta_start"], dp["beta_end"], ldm_scheduler=True,
                                 device="cuda")
    batch = chip_smoke.LDM_BATCH
    hint = torch.as_tensor(chip_smoke.seeded_hints(batch, ds["canny_im_size"]), device="cuda")
    with torch.inference_mode():
        feats = cn.hint_features_chunked(hint.permute(0, 3, 1, 2).contiguous())
    del hint
    lsize = ldm_tool.latent_size(ds, config["autoencoder_params"])
    shape = (batch, cn.trained_unet.im_channels, lsize, lsize)

    def run(dtype):
        sampler = make_ddpm_sampler(lambda m, x, t, f: m(x, t, hint_features=f), sched, shape,
                                    STEPS, dtype, "cuda")
        return sampler(cn, torch.Generator(device="cuda").manual_seed(0), feats)

    return run, batch


def main() -> None:
    parser = argparse.ArgumentParser(description="profile the port's sampling step")
    parser.add_argument("--config", choices=["mnist", "celebhq"], default="mnist")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_step.txt"))
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    report = [f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}; "
              f"config {args.config}"]
    run, batch = mnist_runner() if args.config == "mnist" else celebhq_runner()

    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        run(dtype)  # warm-up
        torch.cuda.synchronize()
        start = time.perf_counter()
        run(dtype)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / STEPS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(dtype)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
                     for e in kernels) / 1e3 / STEPS
        report.append(
            f"{name}: batch {batch}, {STEPS} steps: wall {wall_ms:.3f} ms/step, "
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
