"""Learning-rate schedule: a copy of ``tim_tpu/train/optim.py``'s
``warmup_cosine_schedule`` (plain Python floats, no JAX)."""

from __future__ import annotations

import math


def warmup_cosine_schedule(lr: float, min_lr: float, total_steps: int,
                           warmup_steps: int):
    """cosine(step) * min(1, (step+1)/warmup) — torch CosineAnnealingLR
    with pytorch-warmup LinearWarmup dampening."""

    def schedule(step) -> float:
        t = float(min(step, total_steps))
        cosine = min_lr + 0.5 * (lr - min_lr) * (
            1.0 + math.cos(math.pi * t / max(total_steps, 1)))
        warm = min(1.0, (t + 1.0) / warmup_steps) if warmup_steps > 0 else 1.0
        return cosine * warm

    return schedule
