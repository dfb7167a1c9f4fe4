"""Ancestral DDPM sampling loop on the device.

Port of ``controlnet_tpu/sample/ddpm.py``'s ``make_ddpm_sampler``: the
JAX ``lax.scan`` becomes a plain Python loop over device tensors (no host
round-trip per step; a CUDA graph is later work).  The scheduler update
runs in float32; the model input is cast to ``compute_dtype``.
"""

from __future__ import annotations

from typing import Callable

import torch

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.sample.common import cast_hint, draw_x_start
from controlnet_tpu_torch.schedules.linear import LinearSchedule, sample_prev_timestep


def make_ddpm_sampler(eps_fn: Callable, sched: LinearSchedule, shape: tuple[int, ...],
                      record_every: int = 1, compute_dtype: torch.dtype | None = None,
                      device=None):
    """Build a sampler for full (B, C, H, W) samples of ``shape``.

    ``eps_fn(model, x_t, t_batch[, hint_features])`` predicts epsilon.
    Returns ``sampler(model, generator, hint_features=None, *, x_start=None,
    step_noise=None) -> (x0, trajectory)``: ``trajectory[k]`` is x_t clamped
    to [-1, 1] after (k + 1) * record_every steps, so it holds
    T // record_every frames.  x_T and the per-step noise come from
    ``generator`` (a ``torch.Generator`` on ``device``) unless a caller
    injects them: ``x_start`` of ``shape`` and ``step_noise`` of (T, *shape),
    where ``step_noise[i]`` is the noise of loop step i (timestep T-1-i).
    """
    device = resolve_device(device)
    T = sched.num_timesteps
    if record_every < 1 or T % record_every:
        raise ValueError(f"record_every {record_every} must divide the {T} timesteps")
    b = shape[0]

    @torch.inference_mode()
    def sampler(model, generator: torch.Generator | None, hint_features=None, *,
                x_start: torch.Tensor | None = None, step_noise: torch.Tensor | None = None):
        if x_start is None:
            xt = draw_x_start(generator, shape, device)
        else:
            xt = x_start.to(device=device, dtype=torch.float32)
        hint_c = cast_hint(hint_features, compute_dtype)
        timesteps = torch.arange(T - 1, -1, -1, dtype=torch.int32, device=device)
        traj = []
        for i in range(T):
            t = T - 1 - i
            t_batch = timesteps[i].expand(b)
            x_in = xt if compute_dtype is None else xt.to(compute_dtype)
            if hint_c is None:
                noise_pred = eps_fn(model, x_in, t_batch)
            else:
                noise_pred = eps_fn(model, x_in, t_batch, hint_c)
            if step_noise is not None:
                z = step_noise[i].to(device=device, dtype=torch.float32)
            elif t > 0:
                z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            else:
                z = None  # the last step adds no noise
            xt, _ = sample_prev_timestep(sched, xt, noise_pred.float(), t, z)
            if (i + 1) % record_every == 0:
                traj.append(torch.clamp(xt, -1.0, 1.0))
        return xt, torch.stack(traj)

    return sampler
