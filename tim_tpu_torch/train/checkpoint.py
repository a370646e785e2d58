"""Checkpoint save/load: counterpart of ``tim_tpu/train/checkpoint.py`` in
a torch format.

``<path>/checkpoint.pt`` holds the full train state (parameters under the
reference's state-dict names, optimizer state, step, normaliser, epoch,
extra stats), plus a ``best_<tag>.pt`` copy per tag of ``is_best``, as the
reference names its best checkpoints. The payload holds tensors, numbers,
strings and containers of them only, so ``torch.load(weights_only=True)``
reads it. (The JAX package's msgpack and orbax backends are not ported.)
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch

from tim_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

FILENAME = "checkpoint.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: TrainState, *, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None,
                    is_best: str = "none") -> None:
    """Write ``<path>/checkpoint.pt`` and, for each ``_``-separated tag of
    ``is_best`` (``"none"``: none), ``<path>/best_<tag>.pt``."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "params": _to_cpu(state.model.state_dict()),
        "opt_state": _to_cpu(state.optimizer.state_dict()),
        "normaliser": _to_cpu(state.normaliser),
        "extra": extra or {},
    }
    torch.save(payload, os.path.join(path, FILENAME))
    if is_best and is_best != "none":
        for tag in is_best.split("_"):
            if tag:
                torch.save(payload, os.path.join(path, f"best_{tag}.pt"))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read ``<path>/checkpoint.pt`` (or a ``.pt`` file path) to the CPU."""
    fname = path if path.endswith(".pt") else os.path.join(path, FILENAME)
    return torch.load(fname, map_location="cpu", weights_only=True)


def shape_matched_merge(init: Mapping[str, torch.Tensor],
                        loaded: Mapping[str, torch.Tensor]) -> Dict:
    """Keep loaded entries whose name and shape match ``init`` (a state
    dict); keep ``init``'s values elsewhere, logging both directions (a
    non-strict load)."""
    merged = {}
    for key, val in init.items():
        if key in loaded and tuple(loaded[key].shape) == tuple(val.shape):
            merged[key] = loaded[key]
        else:
            if key in loaded:
                logger.warning("shape mismatch for %s: ckpt %s vs init %s",
                               key, tuple(loaded[key].shape),
                               tuple(val.shape))
            else:
                logger.warning("missing from checkpoint: %s", key)
            merged[key] = val
    for key in loaded:
        if key not in init:
            logger.warning("unused checkpoint entry: %s", key)
    return merged


def restore_train_state(state: TrainState, payload: Mapping) -> TrainState:
    """Full resume in place: parameters (shape-matched), optimizer state,
    step and normaliser."""
    model = state.model
    model.load_state_dict(shape_matched_merge(model.state_dict(),
                                              payload["params"]))
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    state.normaliser = payload["normaliser"].to(state.normaliser.device)
    return state
