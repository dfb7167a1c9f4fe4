"""Linear (DDPM) noise schedule.

Port of ``controlnet_tpu/schedules/linear.py``.  The tables are float32
tensors on one device; the update rules take their noise ``z`` as an
argument, so a caller (or a test) decides where the random numbers come
from.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from controlnet_tpu_torch.device import resolve_device


class LinearSchedule(NamedTuple):
    """Precomputed DDPM schedule tables (all float32, shape [T])."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_cum_prod: torch.Tensor
    sqrt_alpha_cum_prod: torch.Tensor
    sqrt_one_minus_alpha_cum_prod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_linear_schedule(num_timesteps: int, beta_start: float, beta_end: float,
                         ldm_scheduler: bool = False, device=None) -> LinearSchedule:
    """Build the beta/alpha tables.  ``ldm_scheduler=True`` interpolates in
    sqrt-beta space (the CompVis convention the LDM configs use)."""
    device = resolve_device(device)
    f32 = torch.float32
    if ldm_scheduler:
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                               dtype=f32, device=device) ** 2
    else:
        betas = torch.linspace(beta_start, beta_end, num_timesteps, dtype=f32, device=device)
    alphas = 1.0 - betas
    alpha_cum_prod = torch.cumprod(alphas, dim=0)
    return LinearSchedule(
        betas=betas,
        alphas=alphas,
        alpha_cum_prod=alpha_cum_prod,
        sqrt_alpha_cum_prod=torch.sqrt(alpha_cum_prod),
        sqrt_one_minus_alpha_cum_prod=torch.sqrt(1.0 - alpha_cum_prod),
    )


def _bcast(table_at_t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (B,) gather to (B, 1, 1, ...) for broadcasting."""
    return table_at_t.reshape(table_at_t.shape[0], *([1] * (ndim - 1)))


def add_noise(sched: LinearSchedule, original: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1-acp_t) eps.
    ``t`` is an int tensor of shape (B,) (or a scalar)."""
    t = torch.atleast_1d(torch.as_tensor(t, device=original.device)).long()
    sa = _bcast(sched.sqrt_alpha_cum_prod[t], original.ndim)
    soma = _bcast(sched.sqrt_one_minus_alpha_cum_prod[t], original.ndim)
    return sa * original + soma * noise


def eps_to_x0(sched: LinearSchedule, xt: torch.Tensor, noise_pred: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Epsilon prediction at timestep t -> clamped x0 estimate."""
    t = torch.atleast_1d(torch.as_tensor(t, device=xt.device)).long()
    soma = _bcast(sched.sqrt_one_minus_alpha_cum_prod[t], xt.ndim)
    sa = _bcast(sched.sqrt_alpha_cum_prod[t], xt.ndim)
    x0 = (xt - soma * noise_pred) / sa
    return torch.clamp(x0, -1.0, 1.0)


def ddim_step(sched: LinearSchedule, xt: torch.Tensor, noise_pred: torch.Tensor,
              t: int, t_prev: int, z: torch.Tensor | None = None, eta: float = 0.0,
              clip_x0: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step from ``t`` to ``t_prev`` (``t_prev == -1`` is the final
    step, alpha_bar_prev = 1).  ``z`` is the standard-normal noise, needed
    only when ``eta != 0``.  Returns (x_prev, clamped x0 estimate)."""
    acp_t = sched.alpha_cum_prod[t]
    acp_prev = (sched.alpha_cum_prod[t_prev] if t_prev >= 0
                else torch.ones((), dtype=acp_t.dtype, device=acp_t.device))

    x0 = (xt - torch.sqrt(1.0 - acp_t) * noise_pred) / torch.sqrt(acp_t)
    x0_update = torch.clamp(x0, -1.0, 1.0) if clip_x0 else x0

    if eta == 0.0:
        dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev, min=0.0)) * noise_pred
        return torch.sqrt(acp_prev) * x0_update + dir_xt, torch.clamp(x0, -1.0, 1.0)

    if z is None:
        raise ValueError("ddim_step with eta != 0 needs the noise z")
    sigma = eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp_t)) * torch.sqrt(
        1.0 - acp_t / acp_prev)
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * noise_pred
    x_prev = torch.sqrt(acp_prev) * x0_update + dir_xt + sigma * z
    return x_prev, torch.clamp(x0, -1.0, 1.0)


def sample_prev_timestep(sched: LinearSchedule, xt: torch.Tensor, noise_pred: torch.Tensor,
                         t: int, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step: returns (x_{t-1}, clamped x0 prediction).

    ``t`` is a Python int; at ``t == 0`` the posterior mean is returned and
    ``z`` is not used."""
    soma_t = sched.sqrt_one_minus_alpha_cum_prod[t]
    acp_t = sched.alpha_cum_prod[t]
    beta_t = sched.betas[t]
    alpha_t = sched.alphas[t]

    x0 = (xt - soma_t * noise_pred) / torch.sqrt(acp_t)
    x0 = torch.clamp(x0, -1.0, 1.0)

    mean = (xt - beta_t * noise_pred / soma_t) / torch.sqrt(alpha_t)
    if t == 0:
        return mean, x0
    variance = (1.0 - sched.alpha_cum_prod[t - 1]) / (1.0 - acp_t) * beta_t
    sigma = torch.sqrt(variance)
    return mean + sigma * z, x0
