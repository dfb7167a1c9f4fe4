"""Ancestral DDPM sampling loop on the device, and the latent sampler.

Port of ``controlnet_tpu/sample/ddpm.py``: in ``make_ddpm_sampler`` the JAX
``lax.scan`` becomes a plain Python loop over device tensors (no host
round-trip per step; a CUDA graph is later work).  The scheduler update
runs in float32; the model input is cast to ``compute_dtype``.
``make_ldm_sampler`` runs any of the loops in latent space and decodes the
final latent with the VAE.
"""

from __future__ import annotations

from typing import Callable

import torch

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.sample.common import (cast_hint, draw_normal,
                                                gather_result, injected, local_batch,
                                                predict_eps)
from controlnet_tpu_torch.schedules.linear import LinearSchedule, sample_prev_timestep


def make_ddpm_sampler(eps_fn: Callable, sched: LinearSchedule, shape: tuple[int, ...],
                      record_every: int = 1, compute_dtype: torch.dtype | None = None,
                      device=None, mesh=None):
    """Build a sampler for full (B, C, H, W) samples of ``shape``.

    ``eps_fn(model, x_t, t_batch[, hint_features])`` predicts epsilon.
    Returns ``sampler(model, generator, hint_features=None, *, x_start=None,
    step_noise=None) -> (x0, trajectory)``: ``trajectory[k]`` is x_t clamped
    to [-1, 1] after (k + 1) * record_every steps, so it holds
    T // record_every frames.  x_T and the per-step noise come from
    ``generator`` (a ``torch.Generator`` on ``device``) unless a caller
    injects them: ``x_start`` of ``shape`` and ``step_noise`` of (T, *shape),
    where ``step_noise[i]`` is the noise of loop step i (timestep T-1-i).
    ``mesh``: data-parallel sampling over the global batch ``shape``
    (``sample/common.py``); ``hint_features`` are then this rank's rows.
    """
    device = resolve_device(device)
    T = sched.num_timesteps
    if record_every < 1 or T % record_every:
        raise ValueError(f"record_every {record_every} must divide the {T} timesteps")
    b = local_batch(shape, mesh)

    @torch.inference_mode()
    def sampler(model, generator: torch.Generator | None, hint_features=None, *,
                x_start: torch.Tensor | None = None, step_noise: torch.Tensor | None = None):
        if x_start is None:
            xt = draw_normal(generator, shape, device, mesh)
        else:
            xt = injected(x_start, device, mesh)
        hint_c = cast_hint(hint_features, compute_dtype)
        timesteps = torch.arange(T - 1, -1, -1, dtype=torch.int32, device=device)
        traj = []
        for i in range(T):
            t = T - 1 - i
            t_batch = timesteps[i].expand(b)
            noise_pred = predict_eps(eps_fn, model, xt, t_batch, hint_c, compute_dtype)
            if step_noise is not None:
                z = injected(step_noise[i], device, mesh)
            elif t > 0:
                z = draw_normal(generator, shape, device, mesh)
            else:
                z = None  # the last step adds no noise
            xt, _ = sample_prev_timestep(sched, xt, noise_pred, t, z)
            if (i + 1) % record_every == 0:
                traj.append(torch.clamp(xt, -1.0, 1.0))
        return gather_result(xt, traj, mesh)

    return sampler


def make_ldm_sampler(eps_fn: Callable, decode_fn: Callable, sched: LinearSchedule,
                     latent_shape: tuple[int, ...], record_every: int = 1,
                     ddim_steps: int | None = None, eta: float = 0.0, solver: str = "ddim",
                     compute_dtype: torch.dtype | None = None, device=None, mesh=None):
    """Latent-space sampler: the loop runs on latents of ``latent_shape``
    and only the final x_0 is decoded, by ``decode_fn(vae, z)`` (which sees z
    in ``compute_dtype``).

    Returns ``sampler(model, vae, generator, hint_features=None, **noise) ->
    (decoded images, latent trajectory)``; ``noise`` is the latent loop's
    injectable ``x_start`` / ``step_noise``.  ``ddim_steps`` switches the
    latent loop to a few-step sampler (``solver`` "ddim", with ``eta``, or
    "dpm"); ``record_every`` is ignored then (one snapshot per update) and
    the visited timesteps are ``sampler.timesteps`` (None for the ancestral
    loop).

    ``mesh``: data-parallel over the global batch ``latent_shape``, as the
    latent loops are (``sample/common.py``; ``hint_features`` are this
    rank's rows); each rank decodes its own rows of the final latent, and
    the decoded images are gathered.  Returns the global batch on every
    rank."""
    from controlnet_tpu_torch.parallel.mesh import gather_rows
    from controlnet_tpu_torch.sample.common import rank_rows

    device = resolve_device(device)
    if ddim_steps is not None:
        from controlnet_tpu_torch.sample import make_few_step_sampler

        latent_sampler = make_few_step_sampler(solver, eps_fn, sched, latent_shape,
                                               num_steps=ddim_steps, eta=eta,
                                               compute_dtype=compute_dtype, device=device,
                                               mesh=mesh)
    else:
        latent_sampler = make_ddpm_sampler(eps_fn, sched, latent_shape, record_every,
                                           compute_dtype, device, mesh)

    @torch.inference_mode()
    def sampler(model, vae, generator: torch.Generator | None, hint_features=None, **noise):
        z0, traj = latent_sampler(model, generator, hint_features, **noise)
        z0 = rank_rows(z0, mesh)  # the loop's result is gathered; decode this rank's rows
        images = decode_fn(vae, z0 if compute_dtype is None else z0.to(compute_dtype))
        return gather_rows(images, mesh), traj

    sampler.timesteps = getattr(latent_sampler, "timesteps", None)
    return sampler
