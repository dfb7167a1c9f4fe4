"""Fine-tune a canny-hint ControlNet on the trained latent diffusion model.

Counterpart of ``tools/train_ldm_controlnet.py``:

    python -m controlnet_tpu_torch.tools.train_ldm_controlnet \\
        --config config/celebhq.yaml [--hints hints.npy] [--device cpu]

Diffusion runs on latents while the hints stay at ``canny_im_size``, so the
ControlNet's hint encoder is the stride-2 stack of ``down_sample_factor =
canny_im_size // latent_size`` (32 at ``config/celebhq.yaml``), whose
stride-1 convs are kernel c.  Both trunks start from the LDM's
reference-format ``.pth`` at ``<task_name>/<ldm_ckpt_name>`` (what
``train_ldm_vae`` writes); only the control branch, the hint encoder and the
zero convs train.  As in the JAX tool, the CelebA-HQ reader on
``dataset_params.im_path`` gives each image's cached latent moments (the
cache of ``infer_vae`` must hold every image of the tree) and its cv2 canny
hint of the RGB image at ``canny_im_size``, decoded on a host thread batch by
batch.  With ``--hints`` the latents come from the cache alone, in sorted
key order, and the hints from an ``.npy`` of (N, canny_im_size,
canny_im_size, 3) hints in [0, 1] in the same order (the count must match),
held on the host and moved a batch at a time.  The CompVis schedule, Adam at
``controlnet_lr`` cut by 10 at each epoch of ``controlnet_lr_steps``,
``cfg_drop_prob`` from ``train_params``.  Checkpoints of the train state and
the frozen split every ``ckpt_save_every_epochs`` epochs, resumed from the
newest one; at the end the ControlNet's reference-format ``.pth`` at
``<task_name>/<controlnet_ckpt_name>``, which ``sample_ldm_controlnet``
loads.  Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

from controlnet_tpu_torch import cli, config as cfg
from controlnet_tpu_torch.data.datasets import (batch_indices, iterate_batches,
                                                latents_from_batch, load_hints, moments_nchw)
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import (cpu_state_dict, restore_checkpoint,
                                                save_checkpoint, save_file)
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.tools.sample_ldm_vae import latent_size, ldm_schedule
from controlnet_tpu_torch.tools.train_ddpm import epoch_seeds
from controlnet_tpu_torch.tools.train_ldm_vae import cached_moments, latent_reader
from controlnet_tpu_torch.train.loops import make_controlnet_train_step
from controlnet_tpu_torch.train.state import create_train_state, multistep_schedule


def make_trainer(config: dict, ldm_state_dict: dict, steps_per_epoch: int, device=None,
                 seed: int = 0):
    """(ControlNet, train state, step): the latent ControlNet seeded from the
    LDM with its trunk frozen, Adam at ``controlnet_lr`` with gamma 0.1 at
    the ``controlnet_lr_steps`` epochs, the step of ``train_params``."""
    device = resolve_device(device)
    ds = cfg.dataset_params(config)
    ae = cfg.autoencoder_params(config)
    tp = cfg.train_params(config)
    factor = ds["canny_im_size"] // latent_size(ds, ae)
    torch.manual_seed(seed)
    cn = ControlNet(ae["z_channels"], cfg.ldm_params(config), model_locked=True,
                    down_sample_factor=factor)
    cn.init_from_unet(ldm_state_dict)
    cn.to(device)
    trainable, _ = cn.freeze_trunk()
    schedule = multistep_schedule(tp["controlnet_lr"], tp["controlnet_lr_steps"],
                                  steps_per_epoch, 0.1)
    state = create_train_state(trainable, tp["controlnet_lr"], lr_schedule=schedule)
    step = make_controlnet_train_step(cn, ldm_schedule(config, device),
                                      compute_dtype=cli.compute_dtype_from(tp),
                                      cfg_drop_prob=float(tp.get("cfg_drop_prob", 0.0)))
    return cn, state, step


class _CachedPairs:
    """The ``--hints`` route: cached moments on the device (sorted key
    order) and ``.npy`` hints on the host, batched by index."""

    def __init__(self, config: dict, hints_path: str, device):
        tp = cfg.train_params(config)
        self.moments = cached_moments(config, device)
        if self.moments is None:
            raise ValueError("no latent cache under "
                             f"{os.path.join(tp['task_name'], tp['vae_latent_dir_name'])}; "
                             "run infer_vae")
        self.hints = torch.from_numpy(load_hints(hints_path)).permute(0, 3, 1, 2).contiguous()
        size = cfg.dataset_params(config)["canny_im_size"]
        if len(self.hints) != len(self.moments) or tuple(self.hints.shape[2:]) != (size, size):
            raise ValueError(f"hints {tuple(self.hints.shape)} do not match "
                             f"{len(self.moments)} latents at canny_im_size {size}")

    def __len__(self) -> int:
        return len(self.moments)

    def batches(self, batch_size: int, seed: int):
        for idx in batch_indices(len(self.moments), batch_size, shuffle=True, seed=seed):
            yield (self.moments[torch.from_numpy(idx).to(self.moments.device)],
                   self.hints[torch.from_numpy(idx)].to(self.moments.device))


class _TreePairs:
    """The tree route: the reader's (moments, cv2 hint) items, collated on a
    host thread and moved to the device batch by batch."""

    def __init__(self, config: dict, device):
        self.reader = latent_reader(config, return_hint=True)
        if not self.reader.use_latents:
            tp = cfg.train_params(config)
            raise ValueError("the latent cache under "
                             f"{os.path.join(tp['task_name'], tp['vae_latent_dir_name'])} "
                             "does not hold every image of the tree; run infer_vae")
        self.z = cfg.autoencoder_params(config)["z_channels"]
        self.device = device

    def __len__(self) -> int:
        return len(self.reader)

    def batches(self, batch_size: int, seed: int):
        for moments, hints in iterate_batches(self.reader, batch_size, shuffle=True, seed=seed):
            yield (torch.from_numpy(moments_nchw(moments, self.z)).to(self.device),
                   torch.from_numpy(hints).permute(0, 3, 1, 2).contiguous().to(self.device))


def train(config_path: str, hints_path: str | None = None, device=None) -> dict:
    """Train to ``controlnet_epochs``; returns {"epochs": [...], "losses":
    [...]} for the epochs this call ran (mean loss of each)."""
    device = resolve_device(device)
    config = cfg.load_config(config_path)
    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    seed = int(tp.get("seed", 0))
    pairs = (_TreePairs(config, device) if hints_path is None
             else _CachedPairs(config, hints_path, device))
    batch_size = tp["ldm_batch_size"]
    ldm = load_reference_checkpoint(os.path.join(task_name, tp["ldm_ckpt_name"]))
    cn, state, step = make_trainer(config, ldm, max(1, len(pairs) // batch_size), device, seed)
    _, frozen = cn.split_params()

    ckpt_name = tp["controlnet_ckpt_name"]
    start_epoch = 0
    restored = restore_checkpoint(task_name, ckpt_name, map_location=device)
    if restored is not None:
        tree, start_epoch = restored
        state.load_state_dict(tree["state"])
        with torch.no_grad():
            for k, p in frozen.items():
                p.copy_(tree["frozen"][k])
        print(f"Resumed LDM ControlNet from epoch {start_epoch}")

    num_epochs = tp["controlnet_epochs"]
    history = {"epochs": [], "losses": []}
    for epoch_idx in range(start_epoch, num_epochs):
        timer = cli.EpochTimer()
        shuffle_seed, gen_seed = epoch_seeds(seed, epoch_idx)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        for moments, hints in pairs.batches(batch_size, shuffle_seed):
            timer.add(step(state, latents_from_batch(moments, generator), hints, generator))
        print(f"Finished epoch:{epoch_idx + 1} | {timer.summary()}")
        history["epochs"].append(epoch_idx + 1)
        history["losses"].append(timer.mean_loss())
        if cli.should_save_epoch(epoch_idx, num_epochs, tp.get("ckpt_save_every_epochs", 1)):
            tree = {"state": state.state_dict(),
                    "frozen": {k: p.detach() for k, p in frozen.items()}}
            save_checkpoint(task_name, ckpt_name, epoch_idx + 1, tree,
                            max_to_keep=cli.ckpt_max_to_keep(tp))
    save_file(cpu_state_dict(cn), os.path.join(task_name, ckpt_name))
    print("Done Training ...")
    return history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="LDM ControlNet training (PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/celebhq.yaml")
    parser.add_argument("--hints", default=None,
                        help=".npy of (N, canny_im_size, canny_im_size, 3) hints in [0, 1], "
                             "in the latent cache's sorted key order (default: cv2 canny of "
                             "the dataset_params tree)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(args.config_path, args.hints, args.device)


if __name__ == "__main__":
    main()
