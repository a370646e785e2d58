"""Process-0-only logging to stdout + ``<output_dir>/stdout.log``, and the
iter/data/net phase timers: a copy of ``tim_tpu/utils/logging.py``'s
``setup_logging``, ``log_json_stats`` and ``PhaseTimer``, with the process
rank from ``torch.distributed``."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

import torch.distributed as dist


def is_master() -> bool:
    """Rank 0 of an initialised process group, else True."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def setup_logging(output_dir: Optional[str] = None,
                  name: str = "tim_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname)s %(name)s:%(lineno)d] %(message)s",
        datefmt="%m/%d %H:%M:%S")
    if is_master():
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(
                f"{output_dir}/stdout.log", mode="a")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


def log_json_stats(logger: logging.Logger, stats: dict) -> None:
    logger.info("json_stats: %s", json.dumps(stats, sort_keys=True,
                                             default=float))


class PhaseTimer:
    """iter/data/net triplet: call ``data_toc`` after batch fetch,
    ``net_toc`` after device step, ``iter_toc`` at loop end."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.data_time = 0.0
        self.net_time = 0.0
        self.iter_time = 0.0

    def iter_tic(self):
        self._t0 = time.perf_counter()

    def data_toc(self):
        self.data_time = time.perf_counter() - self._t0

    def net_toc(self):
        self.net_time = time.perf_counter() - self._t0 - self.data_time

    def iter_toc(self):
        self.iter_time = time.perf_counter() - self._t0
