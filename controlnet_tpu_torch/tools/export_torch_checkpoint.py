"""Export a port resume checkpoint at a step as a reference-format ``.pth``.

Counterpart of ``tools/export_torch_checkpoint.py``.  The port's trainers
write the final ``.pth`` themselves; this tool turns any saved step
(``<task_name>/<name>/<step>.pt``, ``io/checkpoint.py``; the newest without
``--step``) into the file the reference's tools load with ``strict=True``:

    python -m controlnet_tpu_torch.tools.export_torch_checkpoint \\
        --config config/mnist.yaml --type controlnet [--step 3] [--out cn3.pth] [--force]

The payloads are the reference trainers':

* ``unet``, ``ldm_unet``, ``controlnet``, ``ldm_controlnet``, ``vae``: the
  model's state dict;
* ``consistency``: ``{epoch, model_state_dict, ema_teacher_state_dict,
  model_config}``;
* ``dmd``: ``{epoch, model_state_dict, config}``, written by default as
  ``distribution_matching_controlnet_distilled_ckpt.pth``, the name the
  reference's DMD sample tool opens.

The default source name and output path are the config's checkpoint name
under ``<task_name>``, where the trainer's own final ``.pth`` lives: an
existing file is not overwritten without ``--force``.  The optimizer state
is not exported (the reference never restores it).  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io.checkpoint import cpu_state_dict, restore_checkpoint, save_file
from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train
from controlnet_tpu_torch.tools import (
    train_distribution_matching_controlnet_distilled as dmd_train)

TYPES = ("unet", "ldm_unet", "controlnet", "ldm_controlnet", "vae", "consistency", "dmd")


def _restore(task_name: str, name: str, step: int | None):
    restored = restore_checkpoint(task_name, name, step, map_location=resolve_device("cpu"))
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint for {name} under {task_name}/ — train first")
    tree, step = restored
    print(f"Loaded checkpoint at epoch {step}")
    return tree, step


def _loaded(module, params: dict) -> dict:
    """``module`` with the checkpoint's parameters, strictly: its CPU state dict."""
    module.load_state_dict(params, strict=True)
    return cpu_state_dict(module)


def _controlnet(config: dict, ldm: bool):
    from controlnet_tpu_torch.models.controlnet import ControlNet

    if not ldm:
        mp = cfg.model_params(config)
        return ControlNet(mp["im_channels"], mp, model_locked=True)
    from controlnet_tpu_torch.tools.sample_ldm_vae import latent_size

    ds = cfg.dataset_params(config)
    ae = cfg.autoencoder_params(config)
    factor = ds["canny_im_size"] // latent_size(ds, ae)
    return ControlNet(ae["z_channels"], cfg.ldm_params(config), model_locked=True,
                      down_sample_factor=factor)


def export(config: dict, kind: str, ckpt: str | None = None,
           step: int | None = None) -> tuple[dict, str, int]:
    """(payload, source name, step) of ``kind``'s checkpoint ``ckpt`` (the
    config's name by default) at ``step`` (the newest by default)."""
    from controlnet_tpu_torch.models.unet import UNet

    tp = cfg.train_params(config)
    task_name = tp["task_name"]
    if kind in ("unet", "ldm_unet"):
        key, default = (("ddpm_ckpt_name", "ddpm_ckpt.pth") if kind == "unet"
                        else ("ldm_ckpt_name", "ddpm_ckpt.pth"))
        name = ckpt or tp.get(key, default)
        tree, step = _restore(task_name, name, step)
        if kind == "unet":
            mp = cfg.model_params(config)
            unet = UNet(mp["im_channels"], mp)
        else:
            unet = UNet(cfg.autoencoder_params(config)["z_channels"], cfg.ldm_params(config))
        payload = _loaded(unet, tree["params"])
    elif kind in ("controlnet", "ldm_controlnet"):
        name = ckpt or tp.get("controlnet_ckpt_name", "ddpm_controlnet_ckpt.pth")
        tree, step = _restore(task_name, name, step)
        payload = _loaded(_controlnet(config, kind == "ldm_controlnet"),
                          {**tree["state"]["params"], **tree["frozen"]})
    elif kind == "vae":
        from controlnet_tpu_torch.models.vae import VAE

        name = ckpt or tp.get("vae_autoencoder_ckpt_name", "vae_autoencoder_ckpt.pth")
        tree, step = _restore(task_name, name, step)
        vae = VAE(cfg.dataset_params(config)["im_channels"], cfg.autoencoder_params(config))
        payload = _loaded(vae, tree["g"]["params"])
    elif kind == "consistency":
        from controlnet_tpu_torch.models.consistency import ConsistencyDistilled

        mp = cfg.model_params(config)
        name = ckpt or cd_train.CKPT_NAME
        tree, step = _restore(task_name, name, step)
        model = ConsistencyDistilled(mp["im_channels"], mp, use_ddpm_teacher=False,
                                     device=resolve_device("cpu"))
        model.load_student(tree["state"]["params"], tree["ema"])
        payload = cd_train.reference_checkpoint(model, step, mp)
    elif kind == "dmd":
        from controlnet_tpu_torch.models.dmd import DistributionMatchingControlNet

        mp = cfg.model_params(config)
        name = ckpt or dmd_train.CKPT_NAME
        tree, step = _restore(task_name, name, step)
        student = DistributionMatchingControlNet(mp["im_channels"], mp)
        student.load_state_dict(tree["state"]["params"], strict=True)
        payload = dmd_train.reference_checkpoint(student.state_dict(), step, dict(config))
    else:
        raise ValueError(f"unknown --type {kind}")
    return payload, name, step


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Export a port checkpoint as a reference torch .pth")
    parser.add_argument("--config", dest="config_path", required=True)
    parser.add_argument("--type", required=True, choices=TYPES)
    parser.add_argument("--ckpt", default=None,
                        help="source checkpoint name (default: from config)")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: latest)")
    parser.add_argument("--out", default=None, help="output .pth path")
    parser.add_argument("--force", action="store_true",
                        help="overwrite an existing output file")
    args = parser.parse_args(argv)

    config = cfg.load_config(args.config_path)
    task_name = cfg.train_params(config)["task_name"]
    payload, name, step = export(config, args.type, args.ckpt, args.step)
    out_name = dmd_train.REF_CKPT if args.type == "dmd" and args.ckpt is None else name
    out = args.out or os.path.join(
        task_name, out_name if out_name.endswith(".pth") else out_name + ".pth")
    if os.path.exists(out) and not args.force:
        raise SystemExit(
            f"refusing to overwrite existing {out} (it may be the original "
            f"reference checkpoint) — pass --out <path> or --force")
    save_file(payload, out)
    n = len(payload if args.type not in ("consistency", "dmd")
            else payload["model_state_dict"])
    print(f"Exported {args.type} (epoch {step}, {n} tensors) -> {out}")
    return out


if __name__ == "__main__":
    main()
