"""The consistency-model scheduler, the library-level class.

Port of ``controlnet_tpu/schedules/consistency.py``: the geometric sigma
ladder, forward noising at a ladder index, the adjacent-index
self-consistency loss and 1-step sampling.  The trainers use the fused steps
of ``train/loops.py``; this class is the capability on its own.
"""

from __future__ import annotations

import torch

from controlnet_tpu_torch.schedules.karras import geometric_sigmas


class ConsistencyScheduler:
    def __init__(self, num_timesteps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, device=None):
        self.num_timesteps = num_timesteps
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.rho = rho
        self.sigmas = geometric_sigmas(num_timesteps, sigma_min, sigma_max, device=device)

    def add_noise(self, x0: torch.Tensor, t, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """x_t = x_0 + sigma_t * eps; returns (x_t, eps).  ``noise``
        replaces the draw from ``generator``."""
        t = torch.atleast_1d(torch.as_tensor(t, device=self.sigmas.device)).long()
        sigma = self.sigmas[t].reshape(-1, *([1] * (x0.dim() - 1)))
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        return x0 + sigma * noise, noise

    def consistency_loss(self, model_fn, x_t: torch.Tensor, t, hint: torch.Tensor,
                         x0_target: torch.Tensor, generator: torch.Generator | None = None,
                         noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean((f(x_t, t) - f(x_s, s))^2) with s = clamp(t - 1); ``model_fn(x,
        t, hint)`` is the student."""
        t = torch.atleast_1d(torch.as_tensor(t, device=self.sigmas.device)).long()
        pred_t = model_fn(x_t, t, hint)
        s = torch.clamp(t - 1, 0, self.num_timesteps - 1)
        x_s, _ = self.add_noise(x0_target, s, generator, noise)
        pred_s = model_fn(x_s, s, hint)
        return torch.mean((pred_t - pred_s) ** 2)

    def sample(self, model_fn, x_t: torch.Tensor, t, hint: torch.Tensor) -> torch.Tensor:
        """Single-step sampling: one evaluation of the student, no graph."""
        with torch.no_grad():
            return model_fn(x_t, t, hint)
