"""Sample from a latent (LDM) ControlNet with full-resolution hints:
config -> schedule -> ControlNet + VAE -> latent sampler -> decoded images.

Counterpart of ``tools/sample_ldm_controlnet.py``.  The hint resolution is
decoupled from the latent resolution (``dataset_params.canny_im_size`` against
``im_size`` cut by the VAE's downsamples), so the ControlNet's hint encoder is
the dynamic stride-2 stack.  The hints are encoded once, in chunks of
``--hint_chunk``; the latent loop (the full ancestral one, or ``--sampler
ddim|dpm --sampler_steps N``, each with or without ``--cfg_scale``) and the
VAE decode of the final latent run on the device; the hint grid, one grid of
the latents' first channel per snapshot and the decoded grid are written as
PNGs.

Weights come from reference-format ``.pth`` files (what
``tools/export_torch_checkpoint.py`` writes from JAX checkpoints).  Hints
come, as in the JAX tool, from the CelebA-HQ reader on
``dataset_params.im_path`` (cv2 canny of the RGB image at ``canny_im_size``),
or with ``--hints`` from an ``.npy`` array of (N, H, W, 3) hint images in [0,
1] with H = W = ``canny_im_size``; ``num_samples`` of them are picked at
random from ``--seed``, with replacement.

    python -m controlnet_tpu_torch.tools.sample_ldm_controlnet \\
        --config config/celebhq.yaml [--hints hints.npy] \\
        [--ckpt controlnet.pth] [--vae_ckpt vae.pth] \\
        [--sampler dpm --sampler_steps 20] [--cfg_scale 2.0]

Runs on the card; ``--device cpu`` runs it on the CPU.  Under
``torchrun --nproc_per_node N`` it samples data-parallel, as the JAX tool does
on a mesh: the hints are padded to divide by the data size, each rank
encodes its rows' hints (kernel c), samples and decodes its rows, and rank 0
writes the grids.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from controlnet_tpu_torch import cli
from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.data.datasets import CelebDataset
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.sample.cfg import null_hint_features
from controlnet_tpu_torch.sample.ddpm import make_ldm_sampler
from controlnet_tpu_torch.schedules.linear import LinearSchedule, make_linear_schedule
from controlnet_tpu_torch.tools.sample_ddpm_controlnet import COMPUTE_DTYPES, gather_hints
from controlnet_tpu_torch.tools.sample_ldm_vae import latent_size, load_vae


def load_models(config: dict, ckpt_path: str | None, vae_ckpt_path: str | None,
                device=None) -> tuple[ControlNet, VAE, LinearSchedule]:
    """The latent ControlNet and the VAE (weights from the ``.pth`` files,
    strictly; None leaves a model at its initialisation) and the schedule
    (sqrt-beta interpolation, as the LDM configs use)."""
    device = resolve_device(device)
    dp = cfg.diffusion_params(config)
    ds = cfg.dataset_params(config)
    ae = cfg.autoencoder_params(config)
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 ldm_scheduler=True, device=device)
    factor = ds["canny_im_size"] // latent_size(ds, ae)
    cn = ControlNet(ae["z_channels"], cfg.ldm_params(config), model_locked=True,
                    down_sample_factor=factor)
    if ckpt_path is not None:
        cn.load_state_dict(load_reference_checkpoint(ckpt_path), strict=True)
    return cn.to(device).eval(), load_vae(config, vae_ckpt_path, device), sched


def prepare(cn: ControlNet, sched: LinearSchedule, hints: np.ndarray,
            record_every: int | None = None, compute_dtype: torch.dtype | None = None,
            sampler: str = "ancestral", sampler_steps: int = 50, eta: float = 0.0,
            cfg_scale: float | None = None, hint_chunk: int = 16, mesh=None):
    """The hint features (encoded once, ``hint_chunk`` hints at a time) and
    the latent sampler the flags ask for.  Returns ``(loop, hint_arg)``:
    ``loop(cn, vae, generator, hint_arg)`` samples and decodes one batch, and
    ``loop.timesteps`` is a few-step loop's visited timesteps (None for the
    ancestral loop).  Under a data-parallel ``mesh`` (``cli.sampler_mesh``'s,
    the count of ``hints`` divisible by its data size) the features are this
    rank's rows and the loop samples the global batch."""
    device = next(cn.parameters()).device
    T = sched.num_timesteps
    record_every = T if record_every is None else record_every
    n = len(hints)
    # one copy to contiguous NCHW: the conv kernel reads rows of pixels at
    # stride 1, and from here on the encoder copies nothing of hint size
    hints = cli.put_batch(np.asarray(hints, np.float32), mesh)
    hint = torch.as_tensor(hints, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    factor = cn.down_sample_factor
    if hint.shape[2] % factor or hint.shape[3] % factor:
        raise ValueError(f"hints of {tuple(hint.shape[2:])} do not divide by the "
                         f"down-sample factor {factor}")
    with torch.inference_mode():
        feats = cn.hint_features_chunked(hint, hint_chunk)
        # guidance: the null branch (the zero hint) is encoded once at batch 1
        eps_fn, hint_arg = cli.apply_cfg(
            cfg_scale, lambda m, x, t, f: m(x, t, hint_features=f), feats,
            lambda: null_hint_features(cn.hint_features, hint))
    shape = (n, cn.trained_unet.im_channels, hint.shape[2] // factor, hint.shape[3] // factor)
    few = sampler != "ancestral"
    loop = make_ldm_sampler(eps_fn, lambda vae, z: vae.decode(z), sched, shape,
                            record_every=record_every,
                            ddim_steps=sampler_steps if few else None,
                            eta=eta if few else 0.0, solver=sampler if few else "ddim",
                            compute_dtype=compute_dtype, device=device, mesh=mesh)
    return loop, hint_arg


def sample(cn: ControlNet, vae: VAE, sched: LinearSchedule, hints: np.ndarray, seed: int = 0,
           record_every: int | None = None, compute_dtype: torch.dtype | None = None,
           **sampler_flags):
    """Sample one batch, one sample per hint ((B, H, W, 3) in [0, 1]);
    ``sampler_flags`` are ``prepare``'s (sampler, sampler_steps, eta,
    cfg_scale, hint_chunk).  Returns (decoded images (B, C, H, W), latent
    trajectory (snapshots, B, z, h, w)) as device tensors."""
    loop, hint_arg = prepare(cn, sched, hints, record_every, compute_dtype, **sampler_flags)
    generator = torch.Generator(device=next(cn.parameters()).device).manual_seed(seed)
    return loop(cn, vae, generator, hint_arg)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LDM ControlNet sampling (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--hints", default=None,
                        help=".npy of (N, canny_im_size, canny_im_size, 3) hints in [0, 1] "
                             "(default: cv2 canny of the dataset_params tree)")
    parser.add_argument("--ckpt", default=None,
                        help="reference-format ControlNet .pth "
                             "(default: <task_name>/<controlnet_ckpt_name>)")
    parser.add_argument("--vae_ckpt", default=None,
                        help="reference-format VAE .pth "
                             "(default: <task_name>/<vae_autoencoder_ckpt_name>)")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--save_every", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hint_chunk", type=int, default=16,
                        help="hints encoded at a time (bounds the encoder's memory)")
    parser.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="float32")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli.add_sampler_args(parser)
    cli.add_cfg_args(parser)
    args = parser.parse_args(argv)

    from controlnet_tpu_torch.io.images import save_image_grid

    config = cfg.load_config(args.config_path)
    train_config = cfg.train_params(config)
    task_name = train_config["task_name"]
    ckpt = args.ckpt or os.path.join(task_name, train_config["controlnet_ckpt_name"])
    vae_ckpt = args.vae_ckpt or os.path.join(task_name,
                                             train_config["vae_autoencoder_ckpt_name"])
    cn, vae, sched = load_models(config, ckpt, vae_ckpt, args.device)
    device = next(cn.parameters()).device

    num_samples = args.num_samples or train_config["num_samples"]
    mesh, batch = cli.sampler_mesh(num_samples, device)
    cli.put_replicated((cn, vae), mesh)
    nrow = train_config["num_grid_rows"]
    if args.hints is not None:
        pool = np.load(args.hints)
    else:
        ds = cfg.dataset_params(config)
        pool = CelebDataset("test", im_path=ds["im_path"], im_size=ds["im_size"],
                            im_channels=ds["im_channels"], return_hint=True,
                            canny_im_size=ds["canny_im_size"])
    hints = gather_hints(pool, num_samples, args.seed)
    out_dir = os.path.join(task_name, "hint_samples")
    cli.write_once(mesh, save_image_grid, hints, os.path.join(out_dir, "hints.png"), nrow=nrow)
    if batch != num_samples:  # pad the hints for data-parallel divisibility
        hints = np.concatenate([hints, np.repeat(hints[-1:], batch - num_samples, axis=0)])

    record_every = max(1, args.save_every)
    loop, hint_arg = prepare(cn, sched, hints, record_every,
                             COMPUTE_DTYPES[args.compute_dtype], args.sampler,
                             args.sampler_steps, args.eta, args.cfg_scale, args.hint_chunk, mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    images, traj = loop(cn, vae, generator, hint_arg)
    images = images[:num_samples].float().permute(0, 2, 3, 1).cpu().numpy()
    traj = traj[:, :num_samples].float().permute(0, 1, 3, 4, 2).cpu().numpy()

    def write_grids():
        for k in range(traj.shape[0]):
            t = cli.snapshot_timestep(k, loop.timesteps, sched.num_timesteps, record_every)
            save_image_grid((traj[k][..., :1] + 1.0) / 2.0,
                            os.path.join(out_dir, f"x0_{t}.png"), nrow=nrow)
        save_image_grid((images + 1.0) / 2.0, os.path.join(out_dir, "final_decoded.png"),
                        nrow=nrow)

    cli.write_once(mesh, write_grids)
    cli.say(mesh, f"Wrote hint grid + {traj.shape[0]} latent grids + decoded grid to {out_dir}")
    return images


if __name__ == "__main__":
    main()
