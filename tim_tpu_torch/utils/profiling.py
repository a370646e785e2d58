"""Profiling and experiment tracking hooks: counterpart of
``tim_tpu/utils/profiling.py``.

The reference has no profiler integration (wall-clock timers only) and
hard-wires wandb offline mode (``recognition/scripts/train.py:95-101``).
Here both are optional: ``torch_trace``, a ``torch.profiler`` context that
writes a Chrome / TensorBoard trace (the counterpart of ``xla_trace``),
and ``ExperimentLogger``, a copy of the JAX package's no-op-safe wandb
wrapper.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Capture a host and device trace of the enclosed steps into
    ``log_dir`` (``<worker>.<time>.pt.trace.json``, readable by Perfetto,
    ``chrome://tracing`` and TensorBoard's profiler plugin):

        with torch_trace("runs/trace"):
            for _ in range(3): metrics = train_step(state, batch)

    The CUDA activity is traced when a card is present. An empty
    ``log_dir`` traces nothing. Yields the ``torch.profiler.profile`` (None
    when not tracing)."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class ExperimentLogger:
    """wandb if available and enabled, the python logger otherwise —
    stats are never silently dropped."""

    def __init__(self, enable_wandb: bool = False,
                 project: str = "tim-tpu", config: Optional[Dict] = None,
                 mode: str = "offline"):
        import logging
        self._log = logging.getLogger("tim_tpu_torch")
        self._wandb = None
        if enable_wandb:
            try:
                import wandb
                wandb.init(project=project, config=config or {}, mode=mode)
                self._wandb = wandb
            except Exception as exc:     # any failure: fall back, once
                self._log.warning(
                    "wandb requested but unavailable (%s) — experiment "
                    "stats will go to the python logger instead", exc)

    def log(self, stats: Dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(stats, step=step)
        else:
            self._log.info("experiment%s: %s",
                           f" step {step}" if step is not None else "",
                           stats)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
