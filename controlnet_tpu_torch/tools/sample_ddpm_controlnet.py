"""Sample from a DDPM ControlNet: config -> schedule -> ControlNet -> sampler.

Counterpart of ``tools/sample_ddpm_controlnet.py``.  Weights come from a
reference-format ``.pth`` (what ``tools/export_torch_checkpoint.py`` writes
from a JAX checkpoint).  Hints come, as in the JAX tool, from the test split
of the reader ``dataset_params`` names (cv2 canny of ``im_test_path``'s
images; with ``--hint_backend tpu`` the port's canny of the same images on
the card), or with ``--hints`` from an ``.npy`` array of (N, H, W, 3) hint
images in [0, 1]; ``num_samples`` of them are picked at random from
``--seed``, with replacement, in the JAX tool's order.  The hint features
are computed once, the sampling loop (the 1000-step ancestral one, or
``--sampler ddim|dpm --sampler_steps N``, each with or without
``--cfg_scale``) runs on the device, and the hint grid plus one x_t grid per
``--save_every`` steps (per step of a few-step loop) are written as PNGs.

    python -m controlnet_tpu_torch.tools.sample_ddpm_controlnet \\
        --config config/mnist.yaml [--hints hints.npy | --hint_backend tpu] [--ckpt path.pth] \\
        [--sampler dpm --sampler_steps 20] [--cfg_scale 2.0] [--attn_fused_proj]

Runs on the card; ``--device cpu`` runs it on the CPU.  Under ``torchrun
--nproc_per_node N`` the sample batch is padded up to a multiple of N (the
last hint repeated), each rank samples its rows, and rank 0 writes the grids
of the first ``num_samples``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
from controlnet_tpu_torch.sample.cfg import null_hint_features
from controlnet_tpu_torch.schedules.linear import LinearSchedule, make_linear_schedule

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def gather_hints(hints, num_samples: int, seed: int = 0) -> np.ndarray:
    """``num_samples`` items drawn at random (with replacement) from
    ``hints``, in the draw order of the JAX tool's ``gather_test_hints``: an
    array's rows, or a reader's hints (made with ``return_hints``) or, from a
    reader without hints, its images."""
    rng = random.Random(seed)
    idxs = [rng.randint(0, len(hints) - 1) for _ in range(num_samples)]
    if isinstance(hints, np.ndarray):
        return np.stack([hints[i] for i in idxs])
    items = [hints[i] for i in idxs]
    return np.stack([it[1] if isinstance(it, tuple) else it for it in items])


def split_hints(config: dict, num_samples: int, seed: int, hint_backend: str | None,
                     device) -> np.ndarray:
    """Hints of ``num_samples`` test-split images drawn as the JAX tool
    draws them: cv2 canny in the reader (the default), or with
    ``hint_backend`` tpu the port's canny of the same images on the card.
    (N, H, W, 3) float32 in {0, 1}."""
    from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints

    on_device = hint_backend == "tpu"
    reader = cli.build_dataset(cfg.train_params(config)["task_name"],
                               cfg.dataset_params(config), "test", return_hints=not on_device)
    drawn = gather_hints(reader, num_samples, seed)
    if not on_device:
        return drawn
    images = torch.from_numpy(drawn).permute(0, 3, 1, 2).to(resolve_device(device))
    return device_hints(images).permute(0, 2, 3, 1).float().cpu().numpy()


def load_model(config: dict, ckpt_path: str | None, device=None) -> tuple[ControlNet, LinearSchedule]:
    """The ControlNet (weights from ``ckpt_path``, strictly) and its schedule."""
    device = resolve_device(device)
    dp = cfg.diffusion_params(config)
    mp = cfg.model_params(config)
    sched = make_linear_schedule(dp["num_timesteps"], dp["beta_start"], dp["beta_end"],
                                 device=device)
    cn = ControlNet(mp["im_channels"], mp, model_locked=True)
    if ckpt_path is not None:
        cn.load_state_dict(load_reference_checkpoint(ckpt_path), strict=True)
    return cn.to(device).eval(), sched


def prepare(cn: ControlNet, sched: LinearSchedule, hints: np.ndarray,
            record_every: int | None = None, compute_dtype: torch.dtype | None = None,
            sampler: str = "ancestral", sampler_steps: int = 50, eta: float = 0.0,
            cfg_scale: float | None = None, mesh=None):
    """The hint features (computed once) and the sampling loop the flags ask
    for.  Returns ``(loop, hint_arg, step_ts)``: ``loop(cn, generator,
    hint_arg)`` samples one batch; ``step_ts`` is a few-step loop's visited
    timesteps, None for the ancestral loop.  Under a data-parallel ``mesh``
    (``cli.sampler_mesh``'s, the count of ``hints`` divisible by its world
    size) the features are this rank's rows and the loop samples the global
    batch."""
    device = next(cn.parameters()).device
    T = sched.num_timesteps
    record_every = T if record_every is None else record_every
    n = len(hints)
    hints = cli.put_batch(np.asarray(hints, np.float32), mesh)
    hint = torch.as_tensor(hints, device=device).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = cn.hint_features(hint)
        eps_fn, hint_arg = cli.apply_cfg(
            cfg_scale, lambda m, x, t, f: m(x, t, hint_features=f), feats,
            lambda: null_hint_features(cn.hint_features, hint))
    shape = (n, cn.trained_unet.im_channels, hint.shape[2], hint.shape[3])
    loop, step_ts = cli.select_sampler(sampler, sampler_steps, eta, eps_fn, sched, shape,
                                       record_every, compute_dtype, device, mesh)
    return loop, hint_arg, step_ts


def sample(cn: ControlNet, sched: LinearSchedule, hints: np.ndarray, seed: int = 0,
           record_every: int | None = None, compute_dtype: torch.dtype | None = None,
           **sampler_flags):
    """Sample one batch, one sample per hint ((B, H, W, 3) in [0, 1]);
    ``sampler_flags`` are ``prepare``'s (sampler, sampler_steps, eta,
    cfg_scale).  Returns (x0, trajectory) as (B, C, H, W) / (snapshots, B, C,
    H, W) device tensors: T // record_every snapshots from the ancestral
    loop, one per step from a few-step loop."""
    loop, hint_arg, _ = prepare(cn, sched, hints, record_every, compute_dtype, **sampler_flags)
    generator = torch.Generator(device=next(cn.parameters()).device).manual_seed(seed)
    return loop(cn, generator, hint_arg)


def main(argv=None) -> np.ndarray:
    """Returns the trajectory of the ``num_samples`` samples, (snapshots, N,
    H, W, C) in [-1, 1], as the grids show it."""
    parser = argparse.ArgumentParser(description="DDPM ControlNet sampling (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--hints", default=None,
                        help=".npy of (N, H, W, 3) hints in [0, 1] (default: canny of the "
                             "dataset_params test split, by --hint_backend)")
    cli.add_hint_backend_arg(parser)
    parser.add_argument("--ckpt", default=None,
                        help="reference-format .pth (default: <task_name>/<controlnet_ckpt_name>)")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--save_every", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="float32")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--attn_fused_proj", action="store_true",
                        help="run each self-attention layer the fused kernel takes as one "
                             "launch, projections included (off by default)")
    cli.add_sampler_args(parser)
    cli.add_cfg_args(parser)
    args = parser.parse_args(argv)

    from controlnet_tpu_torch.io.images import save_image_grid

    config = cfg.load_config(args.config_path)
    train_config = cfg.train_params(config)
    task_name = train_config["task_name"]
    ckpt = args.ckpt or os.path.join(task_name, train_config["controlnet_ckpt_name"])
    device = resolve_device(args.device)
    cn, sched = load_model(config, ckpt, device)
    set_attn_fused_proj(cn, args.attn_fused_proj)

    num_samples = args.num_samples or train_config["num_samples"]
    mesh, batch = cli.sampler_mesh(num_samples, device)
    cli.put_replicated(cn, mesh)
    nrow = train_config["num_grid_rows"]
    if args.hints is not None:
        hints = gather_hints(np.load(args.hints), num_samples, args.seed)
    else:
        hints = split_hints(config, num_samples, args.seed, args.hint_backend, device)
    out_dir = os.path.join(task_name, "hint_samples")
    cli.write_once(mesh, save_image_grid, hints, os.path.join(out_dir, "hints.png"), nrow=nrow)
    if batch != num_samples:  # pad the hints for data-parallel divisibility
        hints = np.concatenate([hints, np.repeat(hints[-1:], batch - num_samples, axis=0)])

    record_every = max(1, args.save_every)
    loop, hint_arg, step_ts = prepare(cn, sched, hints, record_every,
                                      COMPUTE_DTYPES[args.compute_dtype], args.sampler,
                                      args.sampler_steps, args.eta, args.cfg_scale, mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    _, traj = loop(cn, generator, hint_arg)
    traj = traj[:, :num_samples].float().permute(0, 1, 3, 4, 2).cpu().numpy()

    def write_grids():
        for k in range(traj.shape[0]):
            t = cli.snapshot_timestep(k, step_ts, sched.num_timesteps, record_every)
            save_image_grid((traj[k] + 1.0) / 2.0, os.path.join(out_dir, f"x0_{t}.png"),
                            nrow=nrow)

    cli.write_once(mesh, write_grids)
    cli.say(mesh, f"Wrote hint grid + {traj.shape[0]} step grids to {out_dir}")
    return traj


if __name__ == "__main__":
    main()
