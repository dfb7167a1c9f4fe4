"""Sample from a trained unconditional DDPM UNet.

Counterpart of ``tools/sample_ddpm.py``:

    python -m controlnet_tpu_torch.tools.sample_ddpm --config config/mnist.yaml \\
        [--ckpt path.pth] [--num_samples N] [--save_every 1] [--seed 0] \\
        [--sampler ddim|dpm --sampler_steps N] [--device cpu]

Weights come from the UNet's reference-format ``.pth``, by default
``<task_name>/<ddpm_ckpt_name>``, where ``train_ddpm`` writes it.  The
1000-step ancestral loop (or a few-step one) runs on the device and writes
``<task_name>/samples/x0_<t>.png``: a grid of the clamped x_t at each
recorded step, every ``--save_every`` steps (1 keeps every step, as the
reference does), per step of a few-step loop.  Runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.schedules.linear import LinearSchedule, make_linear_schedule

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def load_model(config: dict, ckpt_path: str | None, device=None) -> tuple[UNet, LinearSchedule]:
    """The UNet (weights from ``ckpt_path``, strictly) and its schedule."""
    device = resolve_device(device)
    dp = cfg.diffusion_params(config)
    mp = cfg.model_params(config)
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 device=device)
    unet = UNet(mp["im_channels"], mp)
    if ckpt_path is not None:
        unet.load_state_dict(load_reference_checkpoint(ckpt_path), strict=True)
    return unet.to(device).eval(), sched


def prepare(unet: UNet, sched: LinearSchedule, num_samples: int, im_size: int,
            record_every: int | None = None, compute_dtype: torch.dtype | None = None,
            sampler: str = "ancestral", sampler_steps: int = 50, eta: float = 0.0):
    """The sampling loop the flags ask for, for ``num_samples`` samples of
    ``im_size`` squared.  Returns ``(loop, step_ts)``: ``loop(unet, generator, None, x_start=...,
    step_noise=...)`` samples one batch; ``step_ts`` is a few-step loop's
    visited timesteps, None for the ancestral loop."""
    device = next(unet.parameters()).device
    record_every = sched.num_timesteps if record_every is None else record_every
    shape = (num_samples, unet.im_channels, im_size, im_size)
    return cli.select_sampler(sampler, sampler_steps, eta, lambda m, x, t: m(x, t), sched,
                              shape, record_every, compute_dtype, device)


def sample(unet: UNet, sched: LinearSchedule, num_samples: int, im_size: int, seed: int = 0,
           record_every: int | None = None, compute_dtype: torch.dtype | None = None,
           x_start: torch.Tensor | None = None, step_noise: torch.Tensor | None = None,
           **sampler_flags):
    """Sample one batch of ``num_samples``; ``sampler_flags`` are
    ``prepare``'s (sampler, sampler_steps, eta).  x_T and the per-step noise
    come from a generator seeded with ``seed`` unless injected.  Returns (x0,
    trajectory) as (B, C, H, W) / (snapshots, B, C, H, W) device tensors."""
    loop, _ = prepare(unet, sched, num_samples, im_size, record_every, compute_dtype,
                      **sampler_flags)
    generator = torch.Generator(device=next(unet.parameters()).device).manual_seed(seed)
    return loop(unet, generator, None, x_start=x_start, step_noise=step_noise)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="DDPM sampling (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--ckpt", default=None,
                        help="reference-format .pth (default: <task_name>/<ddpm_ckpt_name>)")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--save_every", type=int, default=1,
                        help="record every Nth denoising step (1 = every step)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="float32")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli.add_sampler_args(parser)
    args = parser.parse_args(argv)

    from controlnet_tpu_torch.io.images import save_image_grid

    config = cfg.load_config(args.config_path)
    train_config = cfg.train_params(config)
    task_name = train_config["task_name"]
    unet, sched = load_model(config, args.ckpt or os.path.join(task_name,
                                                               train_config["ddpm_ckpt_name"]),
                             args.device)
    num_samples = args.num_samples or train_config["num_samples"]
    record_every = max(1, args.save_every)
    loop, step_ts = prepare(unet, sched, num_samples, cfg.model_params(config)["im_size"],
                            record_every, COMPUTE_DTYPES[args.compute_dtype], args.sampler,
                            args.sampler_steps, args.eta)
    generator = torch.Generator(device=next(unet.parameters()).device).manual_seed(args.seed)
    _, traj = loop(unet, generator, None)
    traj = traj.float().permute(0, 1, 3, 4, 2).cpu().numpy()
    out_dir = os.path.join(task_name, "samples")
    nrow = train_config["num_grid_rows"]
    for k in range(traj.shape[0]):
        t = cli.snapshot_timestep(k, step_ts, sched.num_timesteps, record_every)
        save_image_grid((traj[k] + 1.0) / 2.0, os.path.join(out_dir, f"x0_{t}.png"), nrow=nrow)
    print(f"Wrote {traj.shape[0]} step grids to {out_dir}")


if __name__ == "__main__":
    main()
