"""Train steps of the DDPM UNet and the ControlNet.

Port of ``controlnet_tpu/train/loops.py``'s ``make_ddpm_train_step`` and
``make_controlnet_train_step``.  Semantics are the JAX step's: a uniform
timestep in [0, T), noise drawn like the images, ``add_noise`` in float32
and then a cast to ``compute_dtype``, the loss mean((f32(pred) - noise)^2),
then one Adam update.  The step updates the train state in place and
returns the loss as a device scalar (reading it would stall the host).

The timesteps, the noise and the condition-drop mask come from an explicit
``torch.Generator``; the step also takes them injected, which is how the
tests hand it the JAX step's draws.  Images and hints are NCHW; the network
runs in ``compute_dtype`` (None = float32) while the parameters, the
schedule math, the loss and the optimizer stay float32.
"""

from __future__ import annotations

from typing import Callable

import torch

from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.schedules.linear import LinearSchedule, add_noise
from controlnet_tpu_torch.train.state import TrainState
from controlnet_tpu_torch.utils.diffusion_utils import drop_image_condition


def _cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _draw(sched: LinearSchedule, images: torch.Tensor, generator: torch.Generator | None,
          t: torch.Tensor | None, noise: torch.Tensor | None):
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (images.shape[0],), generator=generator,
                          device=images.device)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=images.device,
                            dtype=images.dtype)
    return t.to(images.device), noise.to(device=images.device, dtype=images.dtype)


def _update(state: TrainState, pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    loss = torch.mean((pred.float() - noise) ** 2)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_ddpm_train_step(model: Callable, sched: LinearSchedule,
                         compute_dtype: torch.dtype | None = None):
    """``model(x, t)`` predicts epsilon (a UNet).  Returns
    ``step(state, images, generator=None, *, t=None, noise=None) -> loss``
    for float32 images in [-1, 1]; ``state.params`` are the model's."""

    def step(state: TrainState, images: torch.Tensor, generator: torch.Generator | None = None,
             *, t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        t, noise = _draw(sched, images, generator, t, noise)
        noisy = _cast(add_noise(sched, images, noise, t), compute_dtype)
        return _update(state, model(noisy, t), noise)

    return step


def make_controlnet_train_step(cn: ControlNet, sched: LinearSchedule,
                               compute_dtype: torch.dtype | None = None,
                               cfg_drop_prob: float = 0.0):
    """Returns ``step(state, images, hints, generator=None, *, t=None,
    noise=None, keep=None) -> loss``.  ``state.params`` is the trainable
    split of ``cn.freeze_trunk()``, which must have been called: the frozen
    split takes no gradient.  ``cfg_drop_prob`` > 0 zeroes each sample's
    hint with that probability (``keep`` (B,) injects the mask), teaching
    the null condition for classifier-free guidance."""
    _, frozen = cn.split_params()
    if any(p.requires_grad for p in frozen.values()):
        raise ValueError("call ControlNet.freeze_trunk() before building its train step")

    def step(state: TrainState, images: torch.Tensor, hints: torch.Tensor,
             generator: torch.Generator | None = None, *, t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None, keep: torch.Tensor | None = None):
        t, noise = _draw(sched, images, generator, t, noise)
        noisy = _cast(add_noise(sched, images, noise, t), compute_dtype)
        if cfg_drop_prob > 0:
            hints = drop_image_condition(hints, cfg_drop_prob, generator, keep)
        return _update(state, cn(noisy, t, _cast(hints, compute_dtype)), noise)

    return step
