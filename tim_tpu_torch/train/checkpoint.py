"""Checkpoint save/load: counterpart of ``tim_tpu/train/checkpoint.py`` in
a torch format.

``<path>/checkpoint.pt`` holds the full train state (parameters under the
reference's state-dict names, optimizer state, step, normaliser, epoch,
extra stats), plus a ``best_<tag>.pt`` copy per tag of ``is_best``, as the
reference names its best checkpoints. The payload holds tensors, numbers,
strings and containers of them only, so ``torch.load(weights_only=True)``
reads it. (The JAX package's msgpack backend is not ported.)

States sharded over a model axis (``models.tim``'s ``shard_specs``): the
counterpart of JAX's orbax route is one file as well. Save gathers each
sharded parameter and its Adam moments over the model ranks into the
reference-named whole state (every rank joins the gather; global rank 0
writes ``checkpoint.pt``); load reads the whole file and each rank keeps
its slices. The largest TIM state, EPIC detection, is about 60 M fp32
parameters plus two moments, about 0.7 GB: the gather is cheap at that
size, and one format resumes under any mesh and loads strictly into a
one-process ``TimDetection``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch

from tim_tpu_torch.parallel import multihost
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


def _moment_specs(state: TrainState) -> Dict[int, tuple]:
    """The optimizer's index of each sharded parameter -> its (dim,
    blocks) (empty without a model axis)."""
    specs = getattr(state.model, "shard_specs", {})
    if not specs:
        return {}
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return {i: specs[names[id(p)]] for i, p in enumerate(params)
            if names.get(id(p)) in specs}


def _whole_optimizer_state(state: TrainState) -> Dict[str, Any]:
    """The optimizer's state dict, each sharded parameter's moments
    gathered whole over the model ranks (one collective)."""
    opt = state.optimizer.state_dict()
    specs = _moment_specs(state)
    slots = [(i, k) for i in specs for k in sorted(opt["state"].get(i, {}))
             if k.startswith("exp_avg")]
    if slots:
        whole = state.model.mesh.gather_params(
            [(opt["state"][i][k], *specs[i]) for i, k in slots])
        for (i, k), t in zip(slots, whole):
            opt["state"][i] = {**opt["state"][i], k: t}
    return opt


def _sliced_optimizer_state(state: TrainState, opt: Mapping
                            ) -> Dict[str, Any]:
    """A whole optimizer state dict with this rank's slices of the sharded
    parameters' moments."""
    specs = _moment_specs(state)
    if not specs:
        return dict(opt)
    mesh = state.model.mesh
    out = {**opt, "state": dict(opt["state"])}
    for i, (dim, blocks) in specs.items():
        if i in out["state"]:
            out["state"][i] = {
                k: mesh.local_slice(v, dim, blocks)
                if k.startswith("exp_avg") else v
                for k, v in out["state"][i].items()}
    return out


def save_checkpoint(path: str, state: TrainState, *, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None,
                    is_best: str = "none") -> None:
    """Write ``<path>/checkpoint.pt`` and, for each ``_``-separated tag of
    ``is_best`` (``"none"``: none), ``<path>/best_<tag>.pt``. Every rank
    calls it (a sharded state is gathered first); global rank 0
    writes."""
    model = state.model
    params = (model.full_state_dict() if hasattr(model, "full_state_dict")
              else model.state_dict())
    opt_state = _whole_optimizer_state(state)
    if not multihost.is_master():
        return
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "params": _to_cpu(params),
        "opt_state": _to_cpu(opt_state),
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


def merge_params(model: torch.nn.Module,
                 params: Mapping[str, torch.Tensor]) -> None:
    """Load the entries of ``params`` (whole tensors) whose name and shape
    match the model's, keeping its values elsewhere (a non-strict load,
    ``shape_matched_merge``); on a model axis each rank keeps its
    slices."""
    shard = getattr(model, "shard_state_dict", dict)
    model.load_state_dict(shape_matched_merge(model.state_dict(),
                                              shard(params)))


def restore_train_state(state: TrainState, payload: Mapping) -> TrainState:
    """Full resume in place: parameters (shape-matched), optimizer state,
    step and normaliser; on a model axis each rank keeps its slices."""
    merge_params(state.model, payload["params"])
    state.optimizer.load_state_dict(
        _sliced_optimizer_state(state, payload["opt_state"]))
    state.step = int(payload["step"])
    state.normaliser = payload["normaliser"].to(state.normaliser.device)
    return state
