"""Helpers the trainer tools share.

The port's own copy of the parts of ``controlnet_tpu/cli.py`` that the
training slice needs: the compute type from YAML, checkpoint cadence and
retention, and the per-epoch loss timer.
"""

from __future__ import annotations

import time

import torch


def compute_dtype_from(train_config: dict) -> torch.dtype | None:
    """``train_params.compute_dtype`` ("bfloat16" | "float32"): the network's
    forward/backward type.  None (absent or "float32") is full float32."""
    name = str(train_config.get("compute_dtype", "float32")).lower()
    if name in ("float32", "f32", "none"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r} (use bfloat16 or float32)")


class EpochTimer:
    """Per-epoch loss/time accumulator.  ``add`` keeps the device scalar:
    reading it every step would stall the host on the device each step; the
    one synchronisation is in ``summary`` at the end of the epoch."""

    def __init__(self):
        self.t0 = time.time()
        self.losses: list = []

    def add(self, loss: torch.Tensor) -> None:
        self.losses.append(loss.detach())

    def mean_loss(self) -> float:
        if not self.losses:
            return float("nan")
        return torch.stack(self.losses).float().mean().item()

    def summary(self) -> str:
        mean = self.mean_loss()
        return f"mean loss {mean:.4f} | {len(self.losses)} steps | {time.time() - self.t0:.1f}s"


def ckpt_max_to_keep(train_config: dict) -> int:
    """``train_params.ckpt_max_to_keep`` newest checkpoints per name are kept
    (default 3); 0 keeps every one."""
    return int(train_config.get("ckpt_max_to_keep", 3))


def should_save_epoch(epoch_idx: int, num_epochs: int, every: int) -> bool:
    """Every ``every`` epochs, and always after the last one."""
    return (epoch_idx + 1) % max(every, 1) == 0 or (epoch_idx + 1) == num_epochs
