"""Sigma-space (EDM / Karras) schedules of the consistency models.

Port of ``controlnet_tpu/schedules/karras.py``: the geometric sigma ramp of
the consistency scheduler, the Karras rho ladder, forward noising in sigma
space, the sigma -> DDPM timestep lookup and log-uniform sigma draws.  The
tables are float32; random draws come from an explicit ``torch.Generator``
(or are passed in, which is how the tests hand the port the JAX draws).
"""

from __future__ import annotations

import torch


def geometric_sigmas(num_timesteps: int, sigma_min: float, sigma_max: float,
                     device=None) -> torch.Tensor:
    """sigma_i = sigma_min^(1 - r_i) * sigma_max^(r_i), r = linspace(0, 1)."""
    ramp = torch.linspace(0.0, 1.0, num_timesteps, dtype=torch.float32, device=device)
    return torch.pow(sigma_min, 1.0 - ramp) * torch.pow(sigma_max, ramp)


def karras_sigmas(num_steps: int, sigma_min: float, sigma_max: float, rho: float = 7.0,
                  device=None) -> torch.Tensor:
    """The Karras rho-interpolated ladder, ascending from sigma_min to
    sigma_max as in the reference."""
    if num_steps < 2:
        raise ValueError(
            f"karras_sigmas needs num_steps >= 2, got {num_steps} "
            "(the 0/0 interpolation would yield a silent NaN ladder)")
    steps = torch.arange(num_steps, dtype=torch.float32, device=device)
    lo = sigma_min ** (1.0 / rho)
    hi = sigma_max ** (1.0 / rho)
    return (lo + steps / (num_steps - 1) * (hi - lo)) ** rho


def sigma_add_noise(x0: torch.Tensor, sigma, generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t = x_0 + sigma * eps; returns (x_t, eps).  ``sigma`` is (B,) or a
    scalar; ``noise`` replaces the draw from ``generator``."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=x0.dtype, device=x0.device))
    sigma = sigma.reshape(sigma.shape[0], *([1] * (x0.dim() - 1)))
    return x0 + sigma * noise, noise


def sigma_to_timestep(sigma, alpha_cum_prod: torch.Tensor) -> torch.Tensor:
    """The DDPM timestep whose implied sigma sqrt((1 - acp_t) / acp_t) is
    nearest to ``sigma`` (the first on ties).  Returns int32 (B,)."""
    sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32,
                                             device=alpha_cum_prod.device))
    schedule = torch.sqrt((1.0 - alpha_cum_prod) / alpha_cum_prod)
    t = torch.argmin(torch.abs(schedule[None, :] - sigma[:, None]), dim=-1)
    return t.clamp(0, alpha_cum_prod.shape[0] - 1).to(torch.int32)


def sample_log_uniform_sigmas(batch_size: int, sigma_min: float, sigma_max: float,
                              generator: torch.Generator | None = None, device=None,
                              u: torch.Tensor | None = None) -> torch.Tensor:
    """Sigmas log-uniform in [sigma_min, sigma_max]; ``u`` (B,) uniform in
    [0, 1) replaces the draw from ``generator``."""
    if u is None:
        u = torch.rand((batch_size,), generator=generator, device=device, dtype=torch.float32)
    # the logs in float32, as jnp.log of a Python float gives them
    log_min, log_max = torch.log(torch.tensor([sigma_min, sigma_max], dtype=torch.float32,
                                              device=u.device))
    return torch.exp(log_min + u.float() * (log_max - log_min))
