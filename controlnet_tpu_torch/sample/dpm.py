"""DPM-Solver++(2M) sampling loop on the device (second-order few-step sampling).

Port of ``controlnet_tpu/sample/dpm.py``.  Deterministic: the only random
draw is x_T.  With lambda = log(alpha / sigma), alpha = sqrt(acp), sigma =
sqrt(1 - acp), over a descending timestep ladder:

    x0_i   = (x_i - sigma_i * eps(x_i, t_i)) / alpha_i
    h_i+1  = lambda_i+1 - lambda_i
    D      = (1 + c) * x0_i - c * x0_{i-1},  c = h_i / (2 h_i+1)
    x_i+1  = (sigma_i+1 / sigma_i) * x_i - alpha_i+1 * expm1(-h_i+1) * D

``c = 0`` on the first step (no history) and on the last (to alpha_bar = 1,
h = +inf) makes those the first-order update, which is deterministic DDIM.
The per-step constants are computed in float64 on the host, as in the JAX
package, and used as float32 scalars.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.sample.common import cast_hint, draw_x_start, predict_eps
from controlnet_tpu_torch.sample.ddim import ddim_timesteps
from controlnet_tpu_torch.schedules.linear import LinearSchedule


def make_dpm_sampler(eps_fn: Callable, sched: LinearSchedule, shape: tuple[int, ...],
                     num_steps: int, compute_dtype: torch.dtype | None = None, device=None):
    """Build a DPM-Solver++(2M) sampler over ``num_steps`` timesteps.  Same
    contract as ``make_ddim_sampler`` (``sampler(model, generator,
    hint_features=None, *, x_start=None) -> (x0, trajectory)``,
    ``sampler.timesteps``)."""
    device = resolve_device(device)
    ts_np = ddim_timesteps(sched.num_timesteps, num_steps)
    acp = sched.alpha_cum_prod.double().cpu().numpy()
    acp_t = acp[ts_np]
    acp_p = np.concatenate([acp[ts_np[1:]], [1.0]])  # the last target: alpha_bar = 1
    alpha_t, sigma_t = np.sqrt(acp_t), np.sqrt(1.0 - acp_t)
    alpha_p, sigma_p = np.sqrt(acp_p), np.sqrt(1.0 - acp_p)
    with np.errstate(divide="ignore"):  # sigma_p = 0 on the last step: lambda = +inf
        lam_t = np.log(alpha_t / sigma_t)
        lam_p = np.where(sigma_p == 0.0, np.inf,
                         np.log(alpha_p / np.where(sigma_p == 0.0, 1.0, sigma_p)))
    h = lam_p - lam_t
    h_prev = np.concatenate([[0.0], h[:-1]])
    c = np.where(np.isinf(h), 0.0, h_prev / (2.0 * h))
    f32 = np.float32
    consts = list(zip(f32(alpha_t), f32(sigma_t), f32(alpha_p), f32(sigma_p),
                      f32(np.expm1(-np.minimum(h, 1e9))), f32(c)))
    ts = ts_np.tolist()
    b = shape[0]

    @torch.inference_mode()
    def sampler(model, generator: torch.Generator | None, hint_features=None, *,
                x_start: torch.Tensor | None = None):
        if x_start is None:
            xt = draw_x_start(generator, shape, device)
        else:
            xt = x_start.to(device=device, dtype=torch.float32)
        hint_c = cast_hint(hint_features, compute_dtype)
        t_all = torch.tensor(ts, dtype=torch.int32, device=device)
        x0_prev = torch.zeros_like(xt)
        traj = []
        for i, (a_t, s_t, a_p, s_p, em1, ci) in enumerate(consts):
            eps = predict_eps(eps_fn, model, xt, t_all[i].expand(b), hint_c, compute_dtype)
            x0 = (xt - float(s_t) * eps) / float(a_t)
            d = float(f32(1.0) + ci) * x0 - float(ci) * x0_prev
            xt = float(s_p / s_t) * xt - float(a_p * em1) * d
            x0_prev = x0
            traj.append(torch.clamp(xt, -1.0, 1.0))
        return xt, torch.stack(traj)

    sampler.timesteps = ts
    return sampler
