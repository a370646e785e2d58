"""Train state: counterpart of ``tim_tpu/train/state.py``.

The model (its parameters), the optimizer, an optional learning-rate
schedule, the count of updates applied (``step``, a host int) and the
detection loss's EMA normaliser (``normaliser``, a 0-d fp32 tensor on the
model's device; 1.0 unless given, unused by the backbone runners).
``apply_gradients`` applies the gradients that ``backward`` left in the
parameters' ``.grad``: with a ``schedule``, each param group's lr is
``schedule(step) * group["lr_scale"]`` (optax evaluates the schedule at
its update count, starting from 0); then the optimizer steps, the
gradients are cleared and ``step`` advances (also when the optimizer
skipped a non-finite update, as the JAX state's step does). The JAX
package's ``training_rng`` and ``rng_impl`` pick the TPU's random-bit
generator and have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class TrainState:
    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 normaliser: float = 1.0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0
        self.normaliser = torch.tensor(
            normaliser, dtype=torch.float32,
            device=next(model.parameters()).device)

    def apply_gradients(self, normaliser: Optional[torch.Tensor] = None):
        """One optimizer step; ``normaliser`` replaces the state's. Returns
        what the optimizer's ``step`` returns (``AdamWIfFinite``: the
        gradients' global norm)."""
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_scale", 1.0)
        out = self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        if normaliser is not None:
            self.normaliser = normaliser
        return out


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       normaliser: float = 1.0) -> TrainState:
    return TrainState(model, optimizer, normaliser=normaliser)
