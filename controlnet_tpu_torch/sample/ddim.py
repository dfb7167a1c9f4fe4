"""DDIM sampling loop on the device (few-step sampling from DDPM checkpoints).

Port of ``controlnet_tpu/sample/ddim.py``: the same trained epsilon-prediction
checkpoints sampled on a subsequence of the timesteps.  The JAX ``lax.scan``
is a plain Python loop over device tensors, as in ``sample/ddpm.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.sample.common import (cast_hint, draw_normal,
                                                gather_result, injected, local_batch,
                                                predict_eps)
from controlnet_tpu_torch.schedules.linear import LinearSchedule, ddim_step


def ddim_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """The descending timestep subsequence visited by a ``num_steps`` run:
    evenly spaced over [0, T-1] and pinned at both ends (the first entry is
    T-1, the last 0); entries that rounding makes equal are merged."""
    if not 1 <= num_steps <= num_timesteps:
        raise ValueError(f"num_steps {num_steps} outside 1..{num_timesteps}")
    ts = np.linspace(num_timesteps - 1, 0, num_steps).round().astype(np.int64)
    return np.unique(ts)[::-1]


def make_ddim_sampler(eps_fn: Callable, sched: LinearSchedule, shape: tuple[int, ...],
                      num_steps: int, eta: float = 0.0, clip_x0: bool = False,
                      compute_dtype: torch.dtype | None = None, device=None, mesh=None):
    """Build a DDIM sampler over a ``num_steps`` timestep subsequence.

    Same contract as ``make_ddpm_sampler``: ``eps_fn(model, x_t, t_batch[,
    hint_features])`` predicts epsilon; returns ``sampler(model, generator,
    hint_features=None, *, x_start=None, step_noise=None) -> (x0,
    trajectory)`` with one clamped snapshot per step (newest last), and the
    visited timesteps as ``sampler.timesteps`` (descending).  ``eta = 0`` is
    deterministic and draws nothing after x_T; with ``eta != 0`` the noise of
    step i is ``step_noise[i]`` ((steps, *shape)) or drawn from ``generator``.
    ``mesh``: data-parallel sampling as in ``make_ddpm_sampler``.
    """
    device = resolve_device(device)
    ts = ddim_timesteps(sched.num_timesteps, num_steps).tolist()
    ts_prev = ts[1:] + [-1]
    b = local_batch(shape, mesh)

    @torch.inference_mode()
    def sampler(model, generator: torch.Generator | None, hint_features=None, *,
                x_start: torch.Tensor | None = None, step_noise: torch.Tensor | None = None):
        if x_start is None:
            xt = draw_normal(generator, shape, device, mesh)
        else:
            xt = injected(x_start, device, mesh)
        hint_c = cast_hint(hint_features, compute_dtype)
        t_all = torch.tensor(ts, dtype=torch.int32, device=device)
        traj = []
        for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
            noise_pred = predict_eps(eps_fn, model, xt, t_all[i].expand(b), hint_c, compute_dtype)
            if eta == 0.0:
                z = None
            elif step_noise is not None:
                z = injected(step_noise[i], device, mesh)
            else:
                z = draw_normal(generator, shape, device, mesh)
            xt, _ = ddim_step(sched, xt, noise_pred, t, t_prev, z, eta=eta, clip_x0=clip_x0)
            traj.append(torch.clamp(xt, -1.0, 1.0))
        return gather_result(xt, traj, mesh)

    sampler.timesteps = ts
    return sampler
