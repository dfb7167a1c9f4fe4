"""Sample the unconditional latent diffusion model (LDM) and decode with the VAE.

Counterpart of ``tools/sample_ldm_vae.py``:

    python -m controlnet_tpu_torch.tools.sample_ldm_vae --config config/celebhq.yaml \\
        [--ckpt ldm.pth] [--vae_ckpt vae.pth] [--sampler dpm --sampler_steps 20] [--device cpu]

The latent loop (the full ancestral one, or ``--sampler ddim|dpm
--sampler_steps N``) runs on the device from ``--seed``; the VAE decodes only
the final latent.  Under ``<task_name>/samples/`` it writes one grid of the
latents' first channel per snapshot (``x0_{t}.png``, every ``--save_every``
steps of the ancestral loop) and the decoded grid ``final_decoded.png``.
Weights come from reference-format ``.pth`` files: by default the LDM at
``<task_name>/<ldm_ckpt_name>`` (what ``train_ldm_vae`` writes) and the VAE
at ``<task_name>/<vae_autoencoder_ckpt_name>`` (what ``train_vae`` writes).
Runs on the card; ``--device cpu`` runs it on the CPU.  Under
``torchrun --nproc_per_node N`` it samples data-parallel, as the JAX tool does
on a mesh: the count is padded to divide by the data size, each rank runs and
decodes its rows, and rank 0 writes the grids.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli
from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.sample.ddpm import make_ldm_sampler
from controlnet_tpu_torch.schedules.linear import LinearSchedule, make_linear_schedule
from controlnet_tpu_torch.tools.sample_ddpm_controlnet import COMPUTE_DTYPES


def latent_size(dataset_config: dict, autoencoder_config: dict) -> int:
    """Side of the latent grid: ``im_size`` halved once per VAE downsample."""
    n_down = sum(bool(d) for d in autoencoder_config["down_sample"])
    return dataset_config["im_size"] // (2 ** n_down)


def ldm_schedule(config: dict, device) -> LinearSchedule:
    """The latent models' schedule: sqrt-beta interpolation (``ldm_scheduler``)."""
    dp = cfg.diffusion_params(config)
    return make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                ldm_scheduler=True, device=device)


def load_vae(config: dict, path: str | None, device=None) -> VAE:
    """The VAE of ``autoencoder_params`` on ``device``, weights from a
    reference-format ``.pth`` (strictly; None keeps the initialisation)."""
    device = resolve_device(device)
    vae = VAE(cfg.dataset_params(config)["im_channels"], cfg.autoencoder_params(config))
    if path is not None:
        vae.load_state_dict(load_reference_checkpoint(path), strict=True)
    return vae.to(device).eval()


def load_ldm(config: dict, path: str | None, device=None) -> UNet:
    """The LDM UNet of ``ldm_params`` over the VAE's ``z_channels``, weights
    from a reference-format ``.pth`` (strictly; None keeps the
    initialisation)."""
    device = resolve_device(device)
    unet = UNet(cfg.autoencoder_params(config)["z_channels"], cfg.ldm_params(config))
    if path is not None:
        unet.load_state_dict(load_reference_checkpoint(path), strict=True)
    return unet.to(device).eval()


def sample(unet: UNet, vae: VAE, sched: LinearSchedule, num_samples: int, latent: int,
           seed: int = 0, record_every: int | None = None,
           compute_dtype: torch.dtype | None = None, sampler: str = "ancestral",
           sampler_steps: int = 50, eta: float = 0.0, mesh=None):
    """One batch of ``num_samples``: returns (decoded images (B, C, H, W),
    latent trajectory (snapshots, B, z, h, w)) as device tensors, and the
    loop's visited timesteps (None for the ancestral loop).  ``mesh``
    (``cli.sampler_mesh``'s, ``num_samples`` divisible by its data size):
    data-parallel, the global batch returned on every rank."""
    device = next(unet.parameters()).device
    T = sched.num_timesteps
    few = sampler != "ancestral"
    loop = make_ldm_sampler(lambda m, x, t: m(x, t), lambda v, z: v.decode(z), sched,
                            (num_samples, unet.im_channels, latent, latent),
                            record_every=T if record_every is None else record_every,
                            ddim_steps=sampler_steps if few else None, eta=eta if few else 0.0,
                            solver=sampler if few else "ddim", compute_dtype=compute_dtype,
                            device=device, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(seed)
    images, traj = loop(unet, vae, generator)
    return images, traj, loop.timesteps


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LDM sampling (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--ckpt", default=None,
                        help="reference-format LDM .pth (default: <task_name>/<ldm_ckpt_name>)")
    parser.add_argument("--vae_ckpt", default=None,
                        help="reference-format VAE .pth "
                             "(default: <task_name>/<vae_autoencoder_ckpt_name>)")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--save_every", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="float32")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli.add_sampler_args(parser)
    args = parser.parse_args(argv)

    from controlnet_tpu_torch.io.images import save_image_grid

    config = cfg.load_config(args.config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    device = resolve_device(args.device)
    unet = load_ldm(config, args.ckpt or os.path.join(task_name, tp["ldm_ckpt_name"]), device)
    vae = load_vae(config, args.vae_ckpt or os.path.join(task_name,
                                                        tp["vae_autoencoder_ckpt_name"]), device)
    sched = ldm_schedule(config, device)
    num_samples = args.num_samples or tp["num_samples"]
    mesh, batch = cli.sampler_mesh(num_samples, device)
    cli.put_replicated((unet, vae), mesh)
    nrow = tp["num_grid_rows"]
    record_every = max(1, args.save_every)
    latent = latent_size(cfg.dataset_params(config), cfg.autoencoder_params(config))
    images, traj, step_ts = sample(unet, vae, sched, batch, latent, args.seed,
                                   record_every, COMPUTE_DTYPES[args.compute_dtype],
                                   args.sampler, args.sampler_steps, args.eta, mesh)
    images = images[:num_samples].float().permute(0, 2, 3, 1).cpu().numpy()
    traj = traj[:, :num_samples].float().permute(0, 1, 3, 4, 2).cpu().numpy()
    out_dir = os.path.join(task_name, "samples")

    def write_grids():
        for k in range(traj.shape[0]):
            t = cli.snapshot_timestep(k, step_ts, sched.num_timesteps, record_every)
            save_image_grid((traj[k][..., :1] + 1.0) / 2.0,
                            os.path.join(out_dir, f"x0_{t}.png"), nrow=nrow)
        save_image_grid((images + 1.0) / 2.0, os.path.join(out_dir, "final_decoded.png"),
                        nrow=nrow)

    cli.write_once(mesh, write_grids)
    cli.say(mesh, f"Wrote {traj.shape[0]} latent grids + decoded grid to {out_dir}")
    return images


if __name__ == "__main__":
    main()
