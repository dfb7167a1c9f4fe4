"""Train state: the step, the trainable parameters and their optimizer.

Port of ``controlnet_tpu/train/state.py``.  ``optax.adam(lr)`` becomes
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the same update rule
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).  The parameters are updated
in place; ``state_dict`` / ``load_state_dict`` carry the whole state (the
parameters, Adam's moments and step counts, and the step) through a
checkpoint, so a restore resumes exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int
    params: dict  # name -> nn.Parameter, the trainable ones
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict:
        return {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd["params"]) != set(self.params):
            raise ValueError("checkpoint parameters do not match the train state's")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(sd["params"][k])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def create_train_state(params: dict, lr: float) -> TrainState:
    """A fresh state (step 0, Adam moments zero) over ``params`` by name."""
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(step=0, params=dict(params), optimizer=opt)
