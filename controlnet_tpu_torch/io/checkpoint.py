"""Step-numbered checkpoints of the whole train state, with exact resume.

Port of the contract of ``controlnet_tpu/io/checkpoint.py``
(``prune_checkpoints``, ``save_checkpoint``, ``latest_checkpoint``,
``restore_checkpoint``) with ``torch.save`` in place of orbax.  A checkpoint
of name ``ddpm_ckpt.pth`` under ``<task_name>`` lives at
``<task_name>/ddpm_ckpt/<step>.pt``: one file per step holding whatever tree
the trainer saves (parameters, optimizer state and step, and for the
ControlNet the frozen split).  Each write goes to a temporary file that
``os.replace`` then moves into place, so a checkpoint on disk is whole.
``max_to_keep`` keeps the newest steps of a name and deletes the others
after the new one is in place.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_STEP_FILE = re.compile(r"(\d+)\.pt")


def _ckpt_root(ckpt_dir: str, name: str) -> str:
    name = name[:-4] if name.endswith(".pth") else name
    return os.path.abspath(os.path.join(ckpt_dir, name))


def _steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(root) if (m := _STEP_FILE.fullmatch(f)))


def prune_checkpoints(ckpt_dir: str, name: str, max_to_keep: int | None) -> list[int]:
    """Delete all but the newest ``max_to_keep`` steps of ``name``; None or
    <= 0 keeps everything.  Returns the deleted step numbers."""
    root = _ckpt_root(ckpt_dir, name)
    if max_to_keep is None or max_to_keep <= 0:
        return []
    pruned = _steps(root)[:-max_to_keep]
    for s in pruned:
        os.remove(os.path.join(root, f"{s}.pt"))
    return pruned


def save_checkpoint(ckpt_dir: str, name: str, step: int, tree: Any,
                    max_to_keep: int | None = None) -> str:
    """Write ``tree`` as step ``step`` of ``name``; returns the path."""
    root = _ckpt_root(ckpt_dir, name)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{step}.pt")
    save_file(tree, path)
    prune_checkpoints(ckpt_dir, name, max_to_keep)
    return path


def save_file(obj: Any, path: str) -> None:
    """``torch.save`` to a temporary file, then ``os.replace`` into ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def cpu_state_dict(module: torch.nn.Module) -> dict:
    """``module``'s state dict on the CPU: what a reference-format ``.pth`` of
    a model holds."""
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def latest_checkpoint(ckpt_dir: str, name: str) -> int | None:
    """The newest saved step of ``name``, or None."""
    steps = _steps(_ckpt_root(ckpt_dir, name))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, name: str, step: int | None = None,
                       map_location=None) -> tuple[Any, int] | None:
    """(tree, step) of the given or newest step, or None if there is none."""
    if step is None:
        step = latest_checkpoint(ckpt_dir, name)
        if step is None:
            return None
    path = os.path.join(_ckpt_root(ckpt_dir, name), f"{step}.pt")
    return torch.load(path, map_location=map_location, weights_only=True), step
