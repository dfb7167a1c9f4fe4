"""Train state: the step, the trainable parameters and their optimizer.

Port of ``controlnet_tpu/train/state.py``.  ``optax.adam(lr)`` becomes
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the same update rule
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).  The parameters are updated
in place; ``state_dict`` / ``load_state_dict`` carry the whole state (the
parameters, Adam's moments and step counts, and the step) through a
checkpoint, so a restore resumes exactly.

The latent trainers' optimizers: ``multistep_schedule`` is
``optax.piecewise_constant_schedule`` over epoch milestones (the LR of update
k is lr * gamma^(number of milestones m with k >= m * steps_per_epoch)), and
``acc_steps`` > 1 is ``optax.MultiSteps``: every call folds its gradients
into a running mean (Welford's update, as optax computes it) and every
``acc_steps``-th call applies that mean in one Adam update.  The schedule and
Adam's bias correction count updates, not calls.

``ClippedAdamW`` / ``create_dmd_train_state`` are the DMD trainer's optimizer
(clip, AdamW, cosine schedule) with the skipped-batch guard on the device.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable

import torch


def multistep_schedule(lr: float, milestones: list[int], steps_per_epoch: int,
                       gamma: float = 0.5) -> Callable[[int], float]:
    """The LR of update k (0-based): ``lr`` times ``gamma`` for every epoch
    milestone m with k >= m * steps_per_epoch (torch's MultiStepLR counted in
    updates, and ``tools/train_ldm_vae.py``'s ``multistep_adam`` schedule)."""
    bounds = sorted(m * steps_per_epoch for m in milestones)
    return lambda k: lr * gamma ** bisect.bisect_right(bounds, k)


@dataclass
class TrainState:
    step: int  # calls to the train step
    params: dict  # name -> nn.Parameter, the trainable ones
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float] | None = None  # update index -> LR
    acc_steps: int = 1  # calls whose mean gradient makes one update
    updates: int = 0  # optimizer updates applied
    acc: dict = field(default_factory=dict)  # running mean of this window's gradients

    def apply_gradients(self) -> None:
        """Take the parameters' ``.grad`` of one call: an Adam update now
        (``acc_steps`` 1), or a fold into the window's mean, applied on the
        window's last call.  ``.grad`` holds the update's gradient after it."""
        self.step += 1
        if self.acc_steps > 1:
            n = (self.step - 1) % self.acc_steps  # calls already in the window
            with torch.no_grad():
                for k, p in self.params.items():
                    g = torch.zeros_like(p) if p.grad is None else p.grad
                    if n == 0:
                        self.acc[k] = g.clone()
                    else:
                        self.acc[k].add_((g - self.acc[k]) / (n + 1))
            if n + 1 < self.acc_steps:
                return
            for k, p in self.params.items():
                p.grad = self.acc.pop(k)
        if self.lr_schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.updates)
        self.optimizer.step()
        self.updates += 1

    def state_dict(self) -> dict:
        return {"step": self.step, "updates": self.updates,
                "params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": self.optimizer.state_dict(),
                "acc": {k: v.detach() for k, v in self.acc.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd["params"]) != set(self.params):
            raise ValueError("checkpoint parameters do not match the train state's")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(sd["params"][k])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        self.updates = int(sd.get("updates", self.step))
        self.acc = {k: v.to(self.params[k].device).clone() for k, v in sd.get("acc", {}).items()}


def create_train_state(params: dict, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                       lr_schedule: Callable[[int], float] | None = None,
                       acc_steps: int = 1) -> TrainState:
    """A fresh state (step 0, Adam moments zero) over ``params`` by name:
    ``optax.adam(lr, b1, b2)``, with the LR of ``lr_schedule`` (update index
    -> LR) when given, and gradients averaged over ``acc_steps`` calls per
    update (``optax.MultiSteps``)."""
    if acc_steps < 1:
        raise ValueError(f"acc_steps must be at least 1, got {acc_steps}")
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=betas, eps=1e-8)
    return TrainState(step=0, params=dict(params), optimizer=opt, lr_schedule=lr_schedule,
                      acc_steps=acc_steps)


class ClippedAdamW:
    """DMD's optimizer as optax builds it: ``optax.chain(clip_by_global_norm(
    max_norm), adamw(cosine_decay_schedule(lr, decay_steps), weight_decay))``.

    * clip: g / ||g|| * max_norm when ||g|| >= max_norm (optax's rule, with
      no +1e-6 as in ``torch.nn.utils.clip_grad_norm_``);
    * Adam (b1 0.9, b2 0.999, eps 1e-8) with bias correction, then the
      decoupled weight decay added to the update, then the learning rate of
      update k (0-based): lr * (1 + cos(pi * min(k, N) / N)) / 2, in closed
      form as optax evaluates it (not ``CosineAnnealingLR``'s recursion).

    The moments live in two flat float32 buffers and ``count`` (int32) on the
    parameters' device.  ``step(good)`` commits the update only where the
    0-dim bool ``good`` is true, as ``jnp.where(good, new, old)`` does over the
    JAX state: with ``good`` false nothing moves (parameters, moments, count,
    schedule position), and no value is read back to the host."""

    def __init__(self, params, lr: float, decay_steps: int, weight_decay: float = 1e-6,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if decay_steps <= 0:
            raise ValueError(f"decay_steps must be positive, got {decay_steps}")
        self.params = list(params)
        self.lr, self.decay_steps, self.weight_decay = lr, decay_steps, weight_decay
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self._sizes = [p.numel() for p in self.params]
        n, device = sum(self._sizes), self.params[0].device
        self.exp_avg = torch.zeros(n, dtype=torch.float32, device=device)
        self.exp_avg_sq = torch.zeros(n, dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The cosine schedule at update ``count`` (a device tensor)."""
        k = torch.clamp(count, max=self.decay_steps).float()
        return self.lr * (0.5 * (1.0 + torch.cos(torch.pi * k / self.decay_steps)))

    @torch.no_grad()
    def step(self, good: torch.Tensor | None = None) -> torch.Tensor:
        """One update from the parameters' ``.grad``, committed where
        ``good``.  Returns the global norm of the gradients before the clip
        (0 where not ``good``: the JAX step zeroes a skipped batch's
        gradients first)."""
        device = self.exp_avg.device
        good = torch.ones((), dtype=torch.bool, device=device) if good is None else good
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in self.params]).float()
        p_flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        g = torch.where(good, g, torch.zeros_like(g))
        g_norm = torch.sqrt(torch.sum(g * g))  # optax's global_norm; a cascaded sum
        g = torch.where(g_norm < self.max_norm, g, g / g_norm * self.max_norm)
        mu = (1.0 - self.b1) * g + self.b1 * self.exp_avg
        nu = (1.0 - self.b2) * (g * g) + self.b2 * self.exp_avg_sq
        count_inc = self.count + 1
        mu_hat = mu / (1.0 - torch.pow(self.b1, count_inc.float()))
        nu_hat = nu / (1.0 - torch.pow(self.b2, count_inc.float()))
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * p_flat
        new_p = p_flat + (-self.learning_rate(self.count)) * update
        self.exp_avg.copy_(torch.where(good, mu, self.exp_avg))
        self.exp_avg_sq.copy_(torch.where(good, nu, self.exp_avg_sq))
        self.count.copy_(torch.where(good, count_inc, self.count))
        new_p = torch.where(good, new_p, p_flat)
        torch._foreach_copy_(self.params, [v.view_as(p) for v, p in
                                           zip(new_p.split(self._sizes), self.params)])
        return g_norm

    def state_dict(self) -> dict:
        return {"exp_avg": self.exp_avg.clone(), "exp_avg_sq": self.exp_avg_sq.clone(),
                "count": self.count.clone()}

    def load_state_dict(self, sd: dict) -> None:
        if sd["exp_avg"].shape != self.exp_avg.shape:
            raise ValueError("checkpoint moments do not match the parameters")
        self.exp_avg.copy_(sd["exp_avg"])
        self.exp_avg_sq.copy_(sd["exp_avg_sq"])
        self.count.copy_(sd["count"])


def create_dmd_train_state(params: dict, lr: float, decay_steps: int,
                           weight_decay: float = 1e-6, max_norm: float = 1.0) -> TrainState:
    """A fresh DMD state: ``ClippedAdamW`` over ``params`` by name."""
    opt = ClippedAdamW(list(params.values()), lr, decay_steps, weight_decay, max_norm)
    return TrainState(step=0, params=dict(params), optimizer=opt)
