"""The consistency student and consistency distillation of the DDPM ControlNet.

Port of ``controlnet_tpu/models/consistency.py``:

* ``ConsistencyControlNet``: a UNet student with the EDM parameterisation
  (c_skip / c_out / c_in / c_noise), the DDPM hint block with its last conv
  left at its random init (unlike the DMD student's zero conv), its own
  ``t_proj = Sequential(SiLU, Linear)`` (state-dict key ``t_proj.1``), and
  the boundary condition f(x, sigma <= sigma_min) = x applied per sample, as
  the JAX package applies it (the reference applies it to the whole batch).
* ``ConsistencyDistilled``: the student, an EMA copy (decay 0.995) and,
  optionally, the frozen ControlNet teacher on the 1000-step linear
  schedule; the consistency and distillation losses and 1-step / multi-step
  generation.

Reference quirks kept as the JAX package keeps them:

* ``c_in(sigma) * x_t`` multiplies a float32 scale into the input, so the
  UNet runs in float32 even when ``x_t`` is bfloat16 (PyTorch promotes as
  JAX does).  The DMD student and the teacher stay in the input's type.
* The noise-level index truncates: t = clip(int(0.25 ln sigma * 1000), 0,
  999), so every sigma < 1 maps to 0 and every sigma > e^4 to 999.
* Multi-step generation walks the ascending Karras ladder (sigma_min first),
  and the 1-step path draws x_T ~ N(0, 1) unscaled at sigma = sigma_max.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import torch
from torch import nn

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.models.controlnet import ControlNet, fixed_hint_block
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.nn.layers import Linear, Sequential, get_time_embedding
from controlnet_tpu_torch.schedules.karras import (karras_sigmas, sample_log_uniform_sigmas,
                                                   sigma_to_timestep)
from controlnet_tpu_torch.schedules.linear import eps_to_x0, make_linear_schedule


def run_unet(unet: UNet, x: torch.Tensor, hint_out: torch.Tensor,
             t_emb: torch.Tensor) -> torch.Tensor:
    """The UNet's staged forward with the student's own time embedding and
    the hint features added to the stem (both students)."""
    out = unet.stem(x) + hint_out
    out, down_outs = unet.encode(out, t_emb)
    for i in range(len(unet.mids)):
        out = unet.mid_stage(i, out, t_emb)
    return unet.decode(out, down_outs, t_emb)


class ConsistencyControlNet(nn.Module):
    def __init__(self, im_channels: int, model_config: Mapping[str, Any]):
        super().__init__()
        self.unet = UNet(im_channels, model_config)
        self.hint_block = fixed_hint_block(model_config["hint_channels"],
                                           self.unet.down_channels[0], zero_init=False)
        self.t_emb_dim = model_config["time_emb_dim"]
        self.t_proj = Sequential(nn.SiLU(), Linear(self.t_emb_dim, self.t_emb_dim))
        self.sigma_min = model_config.get("sigma_min", 0.002)
        self.sigma_max = model_config.get("sigma_max", 80.0)
        self.sigma_data = model_config.get("sigma_data", 0.5)

    # EDM scalings
    def c_skip(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def c_out(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma * self.sigma_data / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def c_in(self, sigma: torch.Tensor) -> torch.Tensor:
        return 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def c_noise(self, sigma: torch.Tensor) -> torch.Tensor:
        return 0.25 * torch.log(torch.clamp(sigma, min=1e-8))

    def noise_index(self, sigma: torch.Tensor) -> torch.Tensor:
        """The sinusoidal table's index of ``sigma``: int(c_noise * 1000)
        truncated toward zero, clipped to [0, 999]."""
        return torch.clamp((self.c_noise(sigma) * 1000.0).to(torch.int32), 0, 999)

    def forward(self, x_t: torch.Tensor, sigma, hint: torch.Tensor) -> torch.Tensor:
        sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32, device=x_t.device))
        sig4 = sigma.reshape(-1, 1, 1, 1)
        x_scaled = self.c_in(sig4) * x_t  # float32 (see the module docstring)
        t_emb = self.t_proj(get_time_embedding(self.noise_index(sigma), self.t_emb_dim))
        f_theta = run_unet(self.unet, x_scaled, self.hint_block(hint), t_emb)
        x0_pred = self.c_skip(sig4) * x_t + self.c_out(sig4) * f_theta
        return torch.where(sig4 <= self.sigma_min, x_t, x0_pred)


class ConsistencyDistilled(nn.Module):
    """Student + EMA teacher (+ the frozen DDPM ControlNet teacher).

    Only ``student`` trains; ``ema_teacher`` follows it through
    ``update_ema`` after each optimizer step; ``teacher`` (with
    ``use_ddpm_teacher``) is frozen and runs under ``torch.no_grad``.  The
    modules live on ``device`` (None is the card)."""

    def __init__(self, im_channels: int, model_config: Mapping[str, Any],
                 use_ddpm_teacher: bool = True, num_timesteps: int = 1000,
                 ema_decay: float = 0.995, device=None):
        super().__init__()
        device = resolve_device(device)
        self.student = ConsistencyControlNet(im_channels, model_config)
        # a separate copy (no tensor shared with the student) that takes no gradient
        self.ema_teacher = copy.deepcopy(self.student).requires_grad_(False)
        self.use_ddpm_teacher = use_ddpm_teacher
        if use_ddpm_teacher:
            self.teacher = ControlNet(im_channels, model_config, model_locked=True)
            self.teacher.requires_grad_(False)
            self.teacher_schedule = make_linear_schedule(num_timesteps, 0.0001, 0.02,
                                                         device=device)
        self.sigma_min = model_config.get("sigma_min", 0.002)
        self.sigma_max = model_config.get("sigma_max", 80.0)
        self.num_timesteps = num_timesteps
        self.ema_decay = ema_decay
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.student.unet.conv_in.weight.device

    def load_student(self, state_dict: Mapping[str, torch.Tensor],
                     ema_state_dict: Mapping[str, torch.Tensor] | None = None) -> None:
        """Load the student strictly; the EMA from ``ema_state_dict``, or as a
        copy of the student when it is None (as at init)."""
        self.student.load_state_dict(state_dict, strict=True)
        self.ema_teacher.load_state_dict(ema_state_dict or state_dict, strict=True)

    @torch.no_grad()
    def update_ema(self) -> None:
        """ema <- decay * ema + (1 - decay) * student."""
        ema = [p for p in self.ema_teacher.parameters()]
        student = [p.detach() for p in self.student.parameters()]
        torch._foreach_mul_(ema, self.ema_decay)
        torch._foreach_add_(ema, student, alpha=1.0 - self.ema_decay)

    def get_noise_schedule(self, num_steps: int) -> torch.Tensor:
        return karras_sigmas(num_steps, self.sigma_min, self.sigma_max, rho=7.0,
                             device=self.device)

    def sample_sigmas(self, batch_size: int, generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        return sample_log_uniform_sigmas(batch_size, self.sigma_min, self.sigma_max,
                                         generator, self.device)

    def sigma_to_t(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma_to_timestep(sigma, self.teacher_schedule.alpha_cum_prod)

    def ddpm_teacher_prediction(self, x_t: torch.Tensor, sigma: torch.Tensor,
                                hint: torch.Tensor) -> torch.Tensor:
        """The frozen teacher's epsilon at the nearest DDPM timestep, turned
        into a clamped x0."""
        t = self.sigma_to_t(sigma)
        with torch.no_grad():
            noise_pred = self.teacher(x_t, t, hint)
        return eps_to_x0(self.teacher_schedule, x_t, noise_pred, t)

    def consistency_training_loss(self, x0: torch.Tensor, hint: torch.Tensor,
                                  sigma_1: torch.Tensor, sigma_2: torch.Tensor,
                                  noise: torch.Tensor,
                                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """The EMA target at the smaller sigma against the student at the
        larger, one noise for both.  Noising and the MSE stay float32."""
        s1 = torch.minimum(sigma_1, sigma_2)
        s2 = torch.maximum(sigma_1, sigma_2)
        cd = compute_dtype or x0.dtype
        x_s1 = (x0 + s1.reshape(-1, 1, 1, 1) * noise).to(cd)
        x_s2 = (x0 + s2.reshape(-1, 1, 1, 1) * noise).to(cd)
        hint_c = hint.to(cd)
        with torch.no_grad():
            target = self.ema_teacher(x_s1, s1, hint_c)
        pred = self.student(x_s2, s2, hint_c)
        return torch.mean((pred.float() - target.float()) ** 2)

    def distillation_loss(self, x0: torch.Tensor, hint: torch.Tensor, sigma: torch.Tensor,
                          noise: torch.Tensor, alpha: float = 0.5, epoch: int | None = None,
                          total_epochs: int | None = None,
                          compute_dtype: torch.dtype | None = None):
        """alpha * MSE(student, x0) + (1 - alpha) * MSE(student, teacher), with
        the progressive alpha ramp when ``epoch`` and ``total_epochs`` are
        given.  Returns (total, recon, distill)."""
        cd = compute_dtype or x0.dtype
        x_t = (x0 + sigma.reshape(-1, 1, 1, 1) * noise).to(cd)
        hint_c = hint.to(cd)
        x0_student = self.student(x_t, sigma, hint_c).float()
        x0_teacher = self.ddpm_teacher_prediction(x_t, sigma, hint_c).float()
        recon = torch.mean((x0_student - x0.float()) ** 2)
        distill = torch.mean((x0_student - x0_teacher) ** 2)
        if epoch is not None and total_epochs is not None:
            progress = epoch / total_epochs
            alpha = max(alpha * (1 - progress) + 0.1 * progress, 0.1)
        return alpha * recon + (1.0 - alpha) * distill, recon, distill

    @torch.no_grad()
    def generate(self, hint: torch.Tensor, shape, generator: torch.Generator | None = None,
                 num_steps: int = 1, x_start: torch.Tensor | None = None,
                 noise=None) -> torch.Tensor:
        """1-step (x_T ~ N(0, 1) at sigma_max -> x0) or multi-step consistency
        sampling over the Karras ladder.  ``x_start`` replaces the x_T draw and
        ``noise[i]`` the noise re-injected after step i (steps 0 ..
        num_steps - 2)."""
        b = shape[0]
        x = x_start if x_start is not None else torch.randn(
            shape, generator=generator, device=hint.device)
        if num_steps == 1:
            return self.student(x, torch.full((b,), self.sigma_max, device=x.device), hint)
        sigmas = self.get_noise_schedule(num_steps + 1)
        for i in range(num_steps):
            x0 = self.student(x, sigmas[i].expand(b), hint)
            if i == num_steps - 1:
                return x0
            n = noise[i] if noise is not None else torch.randn(
                shape, generator=generator, device=x.device)
            x = x0 + sigmas[i + 1] * n
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
