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

A state that carries a data-parallel ``mesh`` (``parallel.mesh.Mesh``)
averages each call's gradients over the group in one flat all-reduce
(``reduce_gradients``) before any use of them: before the accumulation fold,
Adam, DMD's clip and its skipped-batch guard, so every rank takes the same
update.  On a 2-D mesh the average of a shard's gradient runs over the
rank's data group: under tensor parallelism (``parallel/tp.py``) a rank's
gradients are those of its shards, which its model group does not share, and
Adam runs on each rank's shards; a replicated parameter's gradient and the
loss terms are averaged over every rank.
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
    mesh: object | None = None  # parallel.mesh.Mesh: gradients averaged over its group

    def reduce_gradients(self, *extra: torch.Tensor) -> tuple:
        """Under a mesh, the mean over the group of this call's gradients (in
        ``.grad``, in place) and of the ``extra`` device scalars (the step's
        loss terms), in one flat all-reduce; returns the extras, averaged.  A
        parameter with no gradient keeps none.  Without a mesh: the extras as
        they are."""
        if self.mesh is None:
            return extra
        from controlnet_tpu_torch.parallel.mesh import all_reduce_mean

        with torch.no_grad():
            params = [p for p in self.params.values() if p.grad is not None]
            if self.mesh.model_parallel > 1:
                return self._reduce_tp(params, extra)
            parts = [p.grad.reshape(-1).float() for p in params]
            parts += [e.detach().reshape(1).float() for e in extra]
            flat = all_reduce_mean(torch.cat(parts), self.mesh)
            out = flat.split([x.numel() for x in parts])
            for p, g in zip(params, out):
                p.grad = g.view_as(p).to(p.dtype)
            return tuple(x.reshape(()) for x in out[len(params):])

    def _reduce_tp(self, params: list, extra: tuple) -> tuple:
        """``reduce_gradients`` under tensor parallelism: a shard's gradient
        (``tp_dim``) averaged over the data group; a replicated parameter's,
        equal in exact arithmetic on every rank of a model group, and the
        extras averaged over every rank, so the replicas stay bit-equal
        whatever order their kernels summed in."""
        import torch.distributed as dist

        mesh = self.mesh
        out = []
        for group, size, keep in ((mesh.data_group, mesh.data_size, True),
                                  (None, mesh.world_size, False)):
            mine = [p for p in params if (getattr(p, "tp_dim", None) is not None) == keep]
            parts = [p.grad.reshape(-1).float() for p in mine]
            if not keep:
                parts += [e.detach().reshape(1).float() for e in extra]
            if not parts:
                continue
            flat = torch.cat(parts)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat = flat.div_(size).split([x.numel() for x in parts])
            for p, g in zip(mine, flat):
                p.grad = g.view_as(p).to(p.dtype)
            out = flat[len(mine):]
        return tuple(x.reshape(()) for x in out)

    def apply_gradients(self, *extra: torch.Tensor) -> tuple:
        """Take the parameters' ``.grad`` of one call: an Adam update now
        (``acc_steps`` 1), or a fold into the window's mean, applied on the
        window's last call.  ``.grad`` holds the update's gradient after it.
        Under a mesh the gradients (and ``extra``) are averaged over the group
        first; returns ``extra`` (averaged)."""
        extra = self.reduce_gradients(*extra)
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
                return extra
            for k, p in self.params.items():
                p.grad = self.acc.pop(k)
        if self.lr_schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.updates)
        self.optimizer.step()
        self.updates += 1
        return extra

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
                       acc_steps: int = 1, mesh=None) -> TrainState:
    """A fresh state (step 0, Adam moments zero) over ``params`` by name:
    ``optax.adam(lr, b1, b2)``, with the LR of ``lr_schedule`` (update index
    -> LR) when given, and gradients averaged over ``acc_steps`` calls per
    update (``optax.MultiSteps``) and over ``mesh``'s group."""
    if acc_steps < 1:
        raise ValueError(f"acc_steps must be at least 1, got {acc_steps}")
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=betas, eps=1e-8)
    return TrainState(step=0, params=dict(params), optimizer=opt, lr_schedule=lr_schedule,
                      acc_steps=acc_steps, mesh=mesh)


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
    schedule position), and no value is read back to the host.

    Under tensor parallelism (``tp_mesh`` set by ``create_dmd_train_state``)
    the clip reads the global norm: the squares of the sharded parameters'
    gradients (``tp_dim``) summed over the model group, the replicated ones
    counted once."""

    tp_mesh = None

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
        if self.tp_mesh is None:
            g_norm = torch.sqrt(torch.sum(g * g))  # optax's global_norm; a cascaded sum
        else:
            g_norm = self._tp_norm(g)
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

    def _tp_norm(self, g: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        sharded = torch.cat([torch.full((n,), getattr(p, "tp_dim", None) is not None,
                                        device=g.device)
                             for p, n in zip(self.params, self._sizes)])
        sq = g * g
        part = torch.sum(torch.where(sharded, sq, torch.zeros_like(sq)))
        dist.all_reduce(part, group=self.tp_mesh.model_group)
        return torch.sqrt(torch.sum(torch.where(sharded, torch.zeros_like(sq), sq)) + part)

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
                           weight_decay: float = 1e-6, max_norm: float = 1.0,
                           mesh=None) -> TrainState:
    """A fresh DMD state: ``ClippedAdamW`` over ``params`` by name, its
    gradients averaged over ``mesh``'s data group (and its clip reading the
    global norm of the shards on a model axis above 1)."""
    opt = ClippedAdamW(list(params.values()), lr, decay_steps, weight_decay, max_norm)
    if mesh is not None and mesh.model_parallel > 1:
        opt.tp_mesh = mesh
    return TrainState(step=0, params=dict(params), optimizer=opt, mesh=mesh)
