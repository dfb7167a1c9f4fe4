"""Train steps of the DDPM UNet, the ControlNet, the VAE-GAN and the two
distillers.

Port of ``controlnet_tpu/train/loops.py``'s ``make_ddpm_train_step``,
``make_controlnet_train_step``, ``make_vae_gan_train_step``,
``make_consistency_train_step`` and ``make_dmd_train_step``.  Semantics of the
diffusion steps are the JAX step's: a uniform
timestep in [0, T), noise drawn like the images, ``add_noise`` in float32
and then a cast to ``compute_dtype``, the loss mean((f32(pred) - noise)^2),
then one Adam update.  The step updates the train state in place and
returns the loss as a device scalar (reading it would stall the host).

The timesteps, the noise and the condition-drop mask come from an explicit
``torch.Generator``; the step also takes them injected, which is how the
tests hand it the JAX step's draws.  Images and hints are NCHW; the network
runs in ``compute_dtype`` (None = float32) while the parameters, the
schedule math, the loss and the optimizer stay float32.

Under a data-parallel mesh (``state.mesh``) a step is handed this rank's
rows of the global batch.  Every draw is taken at the global shape from the
same seeded generator on every rank and sliced to the rank's rows (injected
draws are global too, and sliced alike), the gradients and the returned loss
terms are averaged over the group (``TrainState.reduce_gradients``), and
batch statistics are global, so the step equals one process on the global
batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.dmd import DistributionMatchingDistilled
from controlnet_tpu_torch.sample.common import global_batch, rank_rows
from controlnet_tpu_torch.schedules.linear import LinearSchedule, add_noise
from controlnet_tpu_torch.train.state import TrainState
from controlnet_tpu_torch.utils.diffusion_utils import drop_image_condition


def _cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _draw(sched: LinearSchedule, images: torch.Tensor, generator: torch.Generator | None,
          t: torch.Tensor | None, noise: torch.Tensor | None, mesh=None):
    b = global_batch(images.shape[0], mesh)
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (b,), generator=generator,
                          device=images.device)
    if noise is None:
        noise = torch.randn((b, *images.shape[1:]), generator=generator, device=images.device,
                            dtype=images.dtype)
    return (rank_rows(t, mesh).to(images.device),
            rank_rows(noise, mesh).to(device=images.device, dtype=images.dtype))


def _update(state: TrainState, pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    loss = torch.mean((pred.float() - noise) ** 2)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    (loss,) = state.apply_gradients(loss.detach())
    return loss


def make_ddpm_train_step(model: Callable, sched: LinearSchedule,
                         compute_dtype: torch.dtype | None = None):
    """``model(x, t)`` predicts epsilon (a UNet).  Returns
    ``step(state, images, generator=None, *, t=None, noise=None) -> loss``
    for float32 images in [-1, 1]; ``state.params`` are the model's."""

    def step(state: TrainState, images: torch.Tensor, generator: torch.Generator | None = None,
             *, t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        t, noise = _draw(sched, images, generator, t, noise, state.mesh)
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
        mesh = state.mesh
        t, noise = _draw(sched, images, generator, t, noise, mesh)
        noisy = _cast(add_noise(sched, images, noise, t), compute_dtype)
        if cfg_drop_prob > 0:
            if keep is None and mesh is not None:  # the global mask, as _keep_mask draws it
                b = global_batch(images.shape[0], mesh)
                drop = torch.rand((b,), generator=generator, device=hints.device) < cfg_drop_prob
                keep = 1.0 - drop.to(hints.dtype)
            if keep is not None:
                keep = rank_rows(keep, mesh)
            hints = drop_image_condition(hints, cfg_drop_prob, generator, keep)
        return _update(state, cn(noisy, t, _cast(hints, compute_dtype)), noise)

    return step


# ---------------------------------------------------------------------------
# VAE adversarial (GAN) training
# ---------------------------------------------------------------------------

def make_vae_gan_train_step(vae: torch.nn.Module, discriminator: torch.nn.Module,
                            lpips: torch.nn.Module, disc_start: int, disc_weight: float,
                            kl_weight: float, perceptual_weight: float,
                            compute_dtype: torch.dtype | None = None):
    """Returns ``step(g_state, d_state, images, step_count, generator=None,
    *, noise=None) -> metrics`` (device scalars).  ``g_state`` holds the
    VAE's parameters, ``d_state`` the discriminator's; ``lpips`` is frozen
    and runs in float32.

    As the JAX step: the discriminator counts only after ``disc_start``
    steps, as a 0 / 1 weight on its losses, so before then its optimizer
    still takes an update, of zero gradients (Adam's count advances, as
    optax's does); generator loss = MSE + kl_weight * KL + disc_on *
    disc_weight * fool + perceptual_weight * LPIPS, its gradients reaching
    the VAE only; then the discriminator's loss on the detached
    reconstruction and on the input, with the discriminator's parameters
    from before this step's generator update.  The VAE's reparameterisation
    noise (the mean's shape) comes from ``generator`` unless injected."""

    def step(g_state: TrainState, d_state: TrainState, images: torch.Tensor, step_count: int,
             generator: torch.Generator | None = None, *,
             noise: torch.Tensor | None = None) -> dict:
        disc_on = float(step_count > disc_start)
        x_in = _cast(images, compute_dtype)
        recon, enc = vae(x_in, generator, noise)
        mean, logvar = torch.chunk(enc.float(), 2, dim=1)
        kl = torch.mean(0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar,
                                        dim=(1, 2, 3)))
        recon_f = recon.float()
        recon_loss = torch.mean((recon_f - images) ** 2)
        fool = torch.mean((discriminator(recon).float() - 1.0) ** 2)
        lp = torch.mean(lpips(recon_f, images))
        g_loss = (recon_loss + kl_weight * kl + disc_on * disc_weight * fool
                  + perceptual_weight * lp)
        g_params = list(g_state.params.values())
        grads = torch.autograd.grad(g_loss, g_params)
        for p, g in zip(g_params, grads):
            p.grad = g
        g_state.apply_gradients()

        fake_pred = discriminator(recon.detach()).float()
        real_pred = discriminator(x_in).float()
        d_loss = disc_weight * (torch.mean(fake_pred ** 2)
                                + torch.mean((real_pred - 1.0) ** 2)) / 2.0
        d_state.optimizer.zero_grad(set_to_none=True)
        (disc_on * d_loss).backward()
        d_state.apply_gradients()
        metrics = {"recon_loss": recon_loss, "kl_loss": kl,
                   "perceptual_loss": perceptual_weight * lp,
                   "gen_adv_loss": disc_weight * fool * disc_on,
                   "disc_loss": d_loss * disc_on, "g_loss": g_loss}
        return {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# Consistency distillation
# ---------------------------------------------------------------------------

CONSISTENCY_MODES = ("ddpm_distillation", "consistency_only", "manual")


def _check_student_state(student: torch.nn.Module, state: TrainState) -> None:
    ids = {id(p) for p in student.parameters()}
    if {id(p) for p in state.params.values()} != ids:
        raise ValueError("the train state must hold exactly the student's parameters")


def make_consistency_train_step(model: ConsistencyDistilled, state: TrainState,
                                mode: str = "ddpm_distillation", total_epochs: int | None = None,
                                compute_dtype: torch.dtype | None = None):
    """The consistency step of ``mode``, on ``state`` (Adam over
    ``model.student``'s parameters):

    * ``ddpm_distillation``: log-uniform sigma; alpha * recon + (1 - alpha) *
      DDPM-teacher MSE, alpha 0.5;
    * ``consistency_only``: two log-uniform sigmas, the EMA target;
    * ``manual``: one coin per batch: with p = 0.5 every t of the batch comes
      from the top quarter [0.75 T, T), else from [0, T); sigma = sigma_min *
      (sigma_max / sigma_min)^(t / (T - 1)); the combined loss.

    With ``total_epochs`` alpha follows the ramp max(0.5 (1 - p) + 0.1 p,
    0.1), p = epoch / total_epochs.  Noising is float32, then a cast to
    ``compute_dtype``; the EMA is updated after the optimizer step.

    Returns ``step(x0, hint, generator=None, epoch=0, *, sigma=None,
    sigma_2=None, t=None, noise=None) -> metrics`` (device scalars).  The
    keyword arguments replace the draws: ``sigma`` (and ``sigma_2`` in
    ``consistency_only``), the chosen ``t`` in ``manual``, and the noise."""
    if mode not in CONSISTENCY_MODES:
        raise ValueError(f"unknown consistency training mode {mode!r}; expected "
                         "'ddpm_distillation', 'consistency_only', or 'manual'")
    if mode != "consistency_only" and not model.use_ddpm_teacher:
        raise ValueError(f"mode {mode!r} needs the DDPM teacher (use_ddpm_teacher=True)")
    _check_student_state(model.student, state)
    T = model.num_timesteps

    def step(x0: torch.Tensor, hint: torch.Tensor, generator: torch.Generator | None = None,
             epoch: int = 0, *, sigma: torch.Tensor | None = None,
             sigma_2: torch.Tensor | None = None, t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> dict:
        mesh, device = state.mesh, x0.device
        b = global_batch(x0.shape[0], mesh)
        if mode == "consistency_only":
            s1 = model.sample_sigmas(b, generator) if sigma is None else sigma.to(device)
            s2 = model.sample_sigmas(b, generator) if sigma_2 is None else sigma_2.to(device)
            s2 = rank_rows(s2, mesh)
        elif sigma is not None:
            s1 = sigma.to(device)
        elif mode == "manual":
            if t is None:
                coin = torch.rand((), generator=generator, device=device)
                t_hi = torch.randint(int(0.75 * T), T, (b,), generator=generator, device=device)
                t_lo = torch.randint(0, T, (b,), generator=generator, device=device)
                t = torch.where(coin < 0.5, t_hi, t_lo)
            t = t.to(device=device, dtype=torch.float32)
            s1 = model.sigma_min * torch.pow(model.sigma_max / model.sigma_min, t / (T - 1))
        else:
            s1 = model.sample_sigmas(b, generator)
        s1 = rank_rows(s1, mesh)
        if noise is None:
            noise = torch.randn((b, *x0.shape[1:]), generator=generator, device=device,
                                dtype=x0.dtype)
        noise = rank_rows(noise, mesh).to(device=device, dtype=x0.dtype)

        if mode == "consistency_only":
            loss = model.consistency_training_loss(x0, hint, s1, s2, noise,
                                                   compute_dtype=compute_dtype)
            metrics = {"consistency_loss": loss}
        else:
            alpha = 0.5
            if total_epochs is not None:
                progress = epoch / total_epochs
                alpha = max(0.5 * (1.0 - progress) + 0.1 * progress, 0.1)
            loss, recon, distill = model.distillation_loss(x0, hint, s1, noise, alpha=alpha,
                                                           compute_dtype=compute_dtype)
            metrics = {"total_loss": loss, "recon_loss": recon, "distill_loss": distill}
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = dict(zip(metrics, state.reduce_gradients(*metrics.values())))
        state.optimizer.step()
        state.step += 1
        model.update_ema()
        return {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# Distribution-matching distillation
# ---------------------------------------------------------------------------

def make_dmd_train_step(model: DistributionMatchingDistilled, state: TrainState,
                        compute_dtype: torch.dtype | None = None):
    """The DMD step on ``state`` (``create_dmd_train_state`` over
    ``model.student``'s parameters: clip, AdamW, cosine schedule).  One coin
    per batch decides with p = 0.5 whether every t of the batch comes from
    the top quarter [0.75 T, T) or from [0, T).  A batch whose loss is not
    finite moves nothing of the state (the optimizer's commit is a
    ``torch.where`` on the device; nothing is read back to the host).

    Returns ``step(x0, hint, generator=None, *, t=None, noise=None) ->
    metrics``: the loss terms, ``grad_norm`` (before the clip) and
    ``skipped`` (1.0 for a skipped batch), as device scalars."""
    _check_student_state(model.student, state)
    sched = model.teacher_schedule
    T = sched.num_timesteps

    def step(x0: torch.Tensor, hint: torch.Tensor, generator: torch.Generator | None = None,
             *, t: torch.Tensor | None = None, noise: torch.Tensor | None = None) -> dict:
        mesh, device = state.mesh, x0.device
        b = global_batch(x0.shape[0], mesh)
        if t is None:
            t_hi = torch.randint(int(0.75 * T), T, (b,), generator=generator, device=device)
            t_lo = torch.randint(0, T, (b,), generator=generator, device=device)
            coin = torch.rand((), generator=generator, device=device)
            t = torch.where(coin < 0.5, t_hi, t_lo)
        t, noise = _draw(sched, x0, generator, t, noise, mesh)
        x_t = add_noise(sched, x0, noise, t)
        total, dmd, teacher_l, comps = model.distillation_loss(x_t, t, hint, x0,
                                                               compute_dtype=compute_dtype,
                                                               mesh=mesh)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        metrics = {"total_loss": total, "dist_matching_loss": dmd, "teacher_loss": teacher_l,
                   **comps}
        # averaged before the guard reads the loss: every rank skips alike
        metrics = dict(zip(metrics, state.reduce_gradients(*metrics.values())))
        good = torch.isfinite(metrics["total_loss"])
        grad_norm = state.optimizer.step(good)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        metrics["skipped"] = (~good).float()
        return metrics

    return step
