"""Several processes, one card each: counterpart of
``tim_tpu/parallel/multihost.py`` on ``torch.distributed``.

The JAX package brings up ``jax.distributed`` (one controller per host)
and gathers host arrays with ``process_allgather``; the port runs one
process per card, as the reference's DDP launcher does
(``recognition/.../utils/distributed.py``, ``utils/misc.py:88-116``):
``initialize`` joins a process group (NCCL between cards, gloo when the
caller asked for the CPU) and each rank takes its own card. The host-level
helpers below are the identity without a process group, as JAX's are in
one process; with one (even a group of one) they run the collective.

The gathers assume arrays of the same shape on every rank, as JAX's
``process_allgather`` does; the runners' equal-shard padding
(``data.dataset.batch_iterator(num_shards=...)``) guarantees it.

Every collective goes through ``collective``, which counts its calls in
``collective.calls`` (the smoke run sets it to 0 before a run and reads it
after). A gloo group runs ``all_reduce`` and ``broadcast`` on CUDA tensors
itself; ``collective`` stages its other collectives on CUDA tensors
through host memory (and logs each kind once, in ``collective.staged``).
NCCL groups never take that route. The host helpers take a ``group``
(default: every process).
"""

from __future__ import annotations

import logging
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TIMEOUT = timedelta(minutes=10)
# the collectives a gloo group runs on CUDA tensors
_GLOO_CUDA = ("all_reduce", "broadcast", "barrier")


def _on_host(args):
    """``args`` with each CUDA tensor (also in a list) copied to the
    host; returns (host args, [(CUDA tensor, its host copy)])."""
    pairs = []

    def host(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            pairs.append((t, t.cpu()))
            return pairs[-1][1]
        return t

    return ([[host(t) for t in a] if isinstance(a, list) else host(a)
             for a in args], pairs)


def collective(op, *args, **kwargs):
    """``op(*args, **kwargs)``, a ``torch.distributed`` collective,
    counted in ``collective.calls``. In a gloo group, a collective that
    gloo does not run on CUDA tensors runs on host copies of them, copied
    back after it (the first of each kind is logged)."""
    collective.calls += 1
    name = getattr(op, "__name__", str(op))
    if name in _GLOO_CUDA or dist.get_backend(kwargs.get("group")) != "gloo":
        return op(*args, **kwargs)
    host_args, pairs = _on_host(args)
    if not pairs:
        return op(*args, **kwargs)
    if name not in collective.staged:
        collective.staged.add(name)
        logger.warning("gloo group: %s on CUDA tensors staged through host "
                       "memory", name)
    out = op(*host_args, **kwargs)
    for t, h in pairs:
        t.copy_(h)
    return out


collective.calls = 0
collective.staged = set()


def _address(coordinator_address: str) -> str:
    """``tcp://host:port`` from ``tcp://host:port`` or ``host:port``."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None) -> None:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` (``tcp://host:port`` or ``host:port``) as rank
    ``process_id``; nothing for one process, as in JAX. ``device``: None
    or a CUDA device for NCCL, each rank on card ``process_id %
    device_count`` (set as the current device, so that ``"cuda"`` means
    it); ``"cpu"`` for gloo."""
    num_processes = num_processes or 1
    if num_processes <= 1:
        return
    process_id = process_id or 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: NCCL needs a CUDA card and "
                "torch.cuda.is_available() is false; pass device='cpu' "
                "for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "gloo" if cpu else "nccl",
        init_method=_address(coordinator_address or "localhost:9999"),
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def finalize() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_master() -> bool:
    return process_index() == 0


def collective_device(group=None) -> torch.device:
    """Where ``group``'s collectives (default: the process group's) take
    their tensors: the current card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_group(x: np.ndarray, group=None) -> torch.Tensor:
    """``x`` on ``group``'s collective device (bool as uint8: gloo reduces
    no bool)."""
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        collective_device(group))


def _from_group(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    return t.cpu().numpy().astype(like.dtype, copy=False)


def allgather_host_arrays(x: np.ndarray, group=None) -> np.ndarray:
    """Gather a host numpy array (the same shape on every rank) from every
    process of ``group`` (default: all) and concatenate along axis 0, in
    rank order — the role of ``du.all_gather`` for ragged metadata
    (``distributed.py:193-265``). Without a process group: the
    identity."""
    x = np.asarray(x)
    if not initialized():
        return x
    t = _to_group(x, group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    collective(dist.all_gather, parts, t, group=group)
    return np.concatenate([_from_group(p, x) for p in parts], axis=0)


def allreduce_host_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Mean-reduce a dict of host scalars across processes
    (``du.all_reduce`` average semantics), in float64."""
    if not initialized():
        return {k: float(v) for k, v in values.items()}
    keys = sorted(values)
    total = allreduce_host_array(
        np.asarray([float(values[k]) for k in keys], np.float64))
    return dict(zip(keys, (total / dist.get_world_size()).tolist()))


def allreduce_host_array(x: np.ndarray, op: str = "sum", group=None
                         ) -> np.ndarray:
    """Element-wise reduce a host numpy array across the processes of
    ``group`` (default: all; ``sum`` or ``max``), in its own dtype — used
    to merge per-process metric accumulators. Without a process group:
    the identity."""
    x = np.asarray(x)
    if not initialized():
        return x
    if op not in ("sum", "max"):
        raise ValueError(f"allreduce_host_array: op {op!r} (sum or max)")
    t = _to_group(x, group)
    collective(dist.all_reduce, t,
               dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
               group=group)
    return _from_group(t, x)


def barrier(name: str = "barrier") -> None:
    """Wait for every process (``name`` is for the reader: NCCL and gloo
    barriers are anonymous)."""
    if initialized():
        collective(dist.barrier)
