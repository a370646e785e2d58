"""Train state: counterpart of ``tim_tpu/train/state.py``'s ``TrainState``.

The model (its parameters), the optimizer, an optional learning-rate
schedule and the count of updates applied. ``apply_gradients`` applies the
gradients that ``backward`` left in the parameters' ``.grad``: each param
group's lr is ``schedule(step) * group["lr_scale"]`` (optax evaluates the
schedule at its update count, starting from 0), then the optimizer steps
and the gradients are cleared. The JAX package's ``training_rng`` and
``rng_impl`` pick the TPU's random-bit generator and have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0

    def apply_gradients(self) -> None:
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
