"""Checkpoint save/load: counterpart of ``tim_tpu/train/checkpoint.py``,
in a torch format and in the JAX package's msgpack format.

``<path>/checkpoint.pt`` holds the full train state (parameters under the
reference's state-dict names, optimizer state, step, normaliser, epoch,
extra stats), plus a ``best_<tag>.pt`` copy per tag of ``is_best``, as the
reference names its best checkpoints. The payload holds tensors, numbers,
strings and containers of them only, so ``torch.load(weights_only=True)``
reads it. The command lines write this format.

The JAX package's files, ``<path>/checkpoint.msgpack`` and
``best_<tag>.msgpack`` (flax's msgpack layout, ``utils.msgpack``), are
read by ``load_checkpoint`` and written by ``save_jax_checkpoint``: the
payload ``{epoch (int64), step (int32), params (the flax param tree),
opt_state (optax's state dict), normaliser (float32), extra}``. A loaded
msgpack payload stays a flax tree until a model is known: ``merge_params``
and ``restore_train_state`` pick the names from the model's class
(``TimDetection``, ``TimRecognition``, ``PretrainVideoMAE``,
``VideoMAEViT``; ``convert``'s converters), merge the parameters as JAX's
``shape_matched_merge`` merges them (by flax path and shape), and map
the optimizer state through ``optim.if_finite_from_optax``.

JAX's orbax directories, ``<path>/orbax/<epoch>`` (its runners write them
for states sharded across hosts), hold the same payload:
``load_checkpoint_orbax`` reads the newest (or a given) epoch, and
``load_checkpoint`` falls back to it where a directory holds neither
``checkpoint.pt`` nor ``checkpoint.msgpack``, as JAX's does;
``save_checkpoint_orbax`` writes one (``utils.orbax``: OCDBT, zarr and
zstd with no JAX package). The command lines write ``.pt``.

States sharded over a model axis (``models.tim``'s ``shard_specs``) are
saved whole in every format, orbax's too (where JAX writes each host's
shards): save gathers each sharded parameter and its Adam moments over
the model ranks into the whole state (every rank joins the gather;
global rank 0 writes); load reads whole arrays and each rank keeps its
slices. The largest TIM state, EPIC detection, is about 60 M fp32
parameters plus two moments, about 0.7 GB: the gather is cheap at that
size, and one format resumes under any mesh and loads strictly into a
one-process ``TimDetection``.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tim_tpu_torch import convert
from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
from tim_tpu_torch.models.backbones.vit import VideoMAEViT
from tim_tpu_torch.models.tim import TimDetection, TimRecognition
from tim_tpu_torch.parallel import multihost
from tim_tpu_torch.train import optim
from tim_tpu_torch.train.state import TrainState
from tim_tpu_torch.utils import msgpack, orbax

logger = logging.getLogger(__name__)

FILENAME = "checkpoint.pt"
JAX_FILENAME = "checkpoint.msgpack"
ORBAX_DIR = "orbax"


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


def _checkpoint_file(path: str) -> Optional[str]:
    """The file that ``load_checkpoint(path)`` reads: ``path`` itself when
    it ends in ``.pt`` or ``.msgpack``; in a directory ``checkpoint.pt``
    where it holds one, else ``checkpoint.msgpack``; ``None`` for a
    directory that holds neither but JAX's ``orbax/``."""
    if path.endswith((".pt", ".msgpack")):
        return path
    pt, jax_file = (os.path.join(path, f) for f in (FILENAME, JAX_FILENAME))
    if os.path.exists(pt) or not os.path.isdir(path):
        return pt
    if os.path.exists(jax_file):
        return jax_file
    if os.path.isdir(os.path.join(path, ORBAX_DIR)):
        return None
    return pt


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read the checkpoint at ``path`` (``_checkpoint_file``) to the CPU: a
    ``.pt`` payload, or a JAX msgpack or orbax payload (the newest epoch,
    ``load_checkpoint_orbax``) whose ``params`` and ``opt_state`` are flax
    trees (``merge_params`` and ``restore_train_state`` take either)."""
    fname = _checkpoint_file(path)
    if fname is None:
        return load_checkpoint_orbax(path)
    logger.info("reading checkpoint %s", fname)
    if fname.endswith(".msgpack"):
        return msgpack.load(fname)
    return torch.load(fname, map_location="cpu", weights_only=True)


def load_checkpoint_orbax(path: str, epoch: Optional[int] = None
                          ) -> Dict[str, Any]:
    """Read JAX's orbax checkpoint ``<path>/orbax/<epoch>`` (the newest
    committed epoch when ``epoch`` is None: a directory whose name is not
    all digits is a save orbax has not finished) to the CPU: the payload
    of the msgpack route, its arrays as tensors, ``extra``'s numbers as
    Python numbers and optax's empty states as ``{}``. JAX's
    ``params_shardings`` (restoring onto a mesh) has no counterpart: the
    whole arrays are read, and on a model axis each rank keeps its slices
    in ``merge_params`` / ``restore_train_state``."""
    root = os.path.join(os.path.abspath(path), ORBAX_DIR)
    if epoch is None:
        epochs = [int(d) for d in os.listdir(root) if d.isdigit()]
        if not epochs:
            raise FileNotFoundError(f"no orbax checkpoints under {root}")
        epoch = max(epochs)
    step_dir = os.path.join(root, str(epoch))
    logger.info("reading orbax checkpoint %s", step_dir)
    return orbax.read_tree(step_dir)


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


def is_flax_tree(params: Mapping) -> bool:
    """True for a flax param tree (nested dicts, a JAX msgpack payload's
    ``params``), False for a state dict (name -> tensor)."""
    return any(isinstance(v, Mapping) for v in params.values())


def _jax_names(model: torch.nn.Module
              ) -> Tuple[Callable[[Mapping], Dict], Callable[[Mapping], Dict]]:
    """(state dict -> flax tree, flax tree -> state dict) of the model's
    class."""
    if isinstance(model, TimDetection):
        return (convert.detection_params_to_jax,
                lambda t: convert.detection_state_dict_from_jax({"params": t}))
    if isinstance(model, TimRecognition):
        return (convert.recognition_params_to_jax,
                lambda t: convert.recognition_state_dict_from_jax(
                    {"params": t}))
    if isinstance(model, PretrainVideoMAE):
        return (convert.mae_params_to_jax,
                lambda t: convert.mae_state_dict_from_jax({"params": t}))
    if isinstance(model, VideoMAEViT):
        return (convert.vit_params_to_jax,
                lambda t: convert.vit_state_dict_from_jax({"params": t},
                                                          model.depth))
    raise ValueError(f"no flax parameter names for a {type(model).__name__}")


def _whole_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with whole tensors (gathered over a model
    axis: every rank calls it), on the CPU."""
    full = getattr(model, "full_state_dict", model.state_dict)
    return _to_cpu(full())


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(flat: Mapping[str, Any]) -> Dict:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def jax_merge(model: torch.nn.Module, tree: Mapping
              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the model's whole state dict with the flax param tree ``tree``
    merged in, the names of the entries not loaded whole). The merge is
    JAX's ``shape_matched_merge(to_state_dict(params), tree)``: a leaf
    loads where its flax path and shape match the model's, and the three
    warnings name flax paths as JAX's do. Since the converters only
    rearrange, an entry is loaded whole when every leaf it is made of
    loaded (found by converting a tree of 0/1 flags)."""
    to_jax, from_jax = _jax_names(model)
    whole = _whole_state_dict(model)
    init, loaded = _flatten(to_jax(whole)), _flatten(tree)
    merged, flags = {}, {}
    for key, val in init.items():
        got = loaded.get(key)
        ok = got is not None and tuple(np.shape(got)) == tuple(val.shape)
        if not ok:
            if key in loaded:
                logger.warning("shape mismatch for %s: ckpt %s vs init %s",
                               key, tuple(np.shape(got)), tuple(val.shape))
            else:
                logger.warning("missing from checkpoint: %s", key)
        merged[key] = got if ok else val
        flags[key] = np.full((1,) * val.dim(), float(ok), np.float32)
    for key in loaded:
        if key not in init:
            logger.warning("unused checkpoint entry: %s", key)
    state = from_jax(_unflatten(merged))
    loaded_flags = from_jax(_unflatten(flags))
    kept = [n for n in whole
            if n in loaded_flags and not bool(loaded_flags[n].all())]
    return {**whole, **state}, kept


def merge_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load the entries of ``params`` (whole tensors: a state dict, or a
    JAX payload's flax tree, merged by ``jax_merge``) whose name and shape
    match the model's, keeping its values elsewhere (a non-strict load,
    ``shape_matched_merge``); on a model axis each rank keeps its
    slices."""
    if is_flax_tree(params):
        params, _ = jax_merge(model, params)
    shard = getattr(model, "shard_state_dict", dict)
    model.load_state_dict(shape_matched_merge(model.state_dict(),
                                              shard(params)))


def _param_names(state: TrainState) -> List[str]:
    """The model's name of each of the optimizer's parameters, in its
    order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def restore_train_state(state: TrainState, payload: Mapping) -> TrainState:
    """Full resume in place: parameters (shape-matched), optimizer state,
    step and normaliser, from a ``.pt`` or a JAX msgpack payload; on a
    model axis each rank keeps its slices."""
    merge_params(state.model, payload["params"])
    opt_state = payload["opt_state"]
    if "inner_state" in opt_state:
        _, from_jax = _jax_names(state.model)
        opt_state = optim.if_finite_from_optax(
            opt_state, _param_names(state), from_jax,
            state.optimizer.state_dict()["param_groups"])
    state.optimizer.load_state_dict(_sliced_optimizer_state(state,
                                                            opt_state))
    state.step = int(payload["step"])
    state.normaliser = torch.as_tensor(payload["normaliser"]).to(
        device=state.normaliser.device, dtype=torch.float32)
    return state


def _jax_payload(state: TrainState, epoch: int,
                 extra: Optional[Dict[str, Any]]) -> Optional[Dict]:
    """The JAX package's checkpoint payload of ``state`` on global rank 0
    (``None`` elsewhere); every rank calls it (a sharded state is
    gathered first)."""
    to_jax, _ = _jax_names(state.model)
    params = _whole_state_dict(state.model)
    opt = _whole_optimizer_state(state)
    if not multihost.is_master():
        return None
    pairs = [(n, params[n]) for n in _param_names(state)]
    if isinstance(state.optimizer, optim.AdamWIfFinite):
        opt_tree = optim.if_finite_to_optax(opt, pairs, to_jax)
    elif isinstance(state.optimizer, torch.optim.AdamW):
        opt_tree = optim.adamw_to_optax(opt, pairs, to_jax)
    else:
        raise ValueError(f"no optax layout for a "
                         f"{type(state.optimizer).__name__}")
    return {
        "epoch": np.asarray(int(epoch), np.int64),
        "step": np.asarray(int(state.step), np.int32),
        "params": to_jax(params),
        "opt_state": opt_tree,
        "normaliser": _to_cpu(state.normaliser).to(torch.float32)
        .reshape(()),
        "extra": extra or {},
    }


def save_jax_checkpoint(path: str, state: TrainState, *, epoch: int = 0,
                        extra: Optional[Dict[str, Any]] = None,
                        is_best: str = "none") -> Optional[int]:
    """Write ``<path>/checkpoint.msgpack`` and, for each ``_``-separated
    tag of ``is_best``, ``<path>/best_<tag>.msgpack``: the JAX package's
    payload (``tim_tpu/train/checkpoint.py::save_checkpoint``), which its
    ``load_checkpoint`` + ``restore_train_state`` resume from. TIM states
    (``AdamWIfFinite``) and the MAE pretraining state
    (``torch.optim.AdamW``). Every rank calls it (a sharded state is
    gathered first); global rank 0 writes and gets the file's bytes."""
    payload = _jax_payload(state, epoch, extra)
    if payload is None:
        return None
    os.makedirs(path, exist_ok=True)
    blob = msgpack.msgpack_serialize(payload)
    tags = [] if is_best in (None, "none") else [
        t for t in is_best.split("_") if t]
    for name in [JAX_FILENAME] + [f"best_{t}.msgpack" for t in tags]:
        with open(os.path.join(path, name), "wb") as f:
            f.write(blob)
    return len(blob)


def save_checkpoint_orbax(path: str, state: TrainState, *, epoch: int = 0,
                          extra: Optional[Dict[str, Any]] = None
                          ) -> Optional[Dict[str, int]]:
    """Write ``<path>/orbax/<epoch>`` as JAX's ``save_checkpoint_orbax``
    does from one process on the CPU (``utils.orbax.write_tree``): the
    payload of ``save_jax_checkpoint``, its parameters and optimizer state
    as ``jax.Array`` leaves, ``epoch``, ``step`` and ``normaliser`` as
    ``np.ndarray`` and ``extra``'s Python numbers as scalars (orbax stores
    no strings). TIM states and the MAE pretraining state. Every rank
    calls it (a sharded state is gathered first); global rank 0 writes
    into ``<epoch>.orbax-checkpoint-tmp-<ns>`` and renames it when done,
    replacing an earlier save of the epoch, so an interrupted save is
    never taken for the newest epoch; it gets the bytes written. The
    write is synchronous, as the JAX runners' saves are."""
    payload = _jax_payload(state, epoch, extra)
    if payload is None:
        return None
    payload["normaliser"] = payload["normaliser"].numpy()
    root = os.path.join(os.path.abspath(path), ORBAX_DIR)
    final = os.path.join(root, str(int(epoch)))
    tmp = f"{final}.orbax-checkpoint-tmp-{time.time_ns()}"
    os.makedirs(root, exist_ok=True)
    try:
        sizes = orbax.write_tree(tmp, payload)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return sizes
