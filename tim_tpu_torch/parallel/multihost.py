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
after).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=10)


def collective(op, *args, **kwargs):
    """``op(*args, **kwargs)``, a ``torch.distributed`` collective,
    counted in ``collective.calls``."""
    collective.calls += 1
    return op(*args, **kwargs)


collective.calls = 0


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


def collective_device() -> torch.device:
    """Where the process group's collectives take their tensors: the
    current card for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_group(x: np.ndarray) -> torch.Tensor:
    """``x`` on the collective device (bool as uint8: gloo reduces no
    bool)."""
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(x)).to(collective_device())


def _from_group(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    return t.cpu().numpy().astype(like.dtype, copy=False)


def allgather_host_arrays(x: np.ndarray) -> np.ndarray:
    """Gather a host numpy array (the same shape on every rank) from every
    process and concatenate along axis 0, in rank order — the role of
    ``du.all_gather`` for ragged metadata (``distributed.py:193-265``).
    Without a process group: the identity."""
    x = np.asarray(x)
    if not initialized():
        return x
    t = _to_group(x)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    collective(dist.all_gather, parts, t)
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


def allreduce_host_array(x: np.ndarray, op: str = "sum") -> np.ndarray:
    """Element-wise reduce a host numpy array across processes (``sum`` or
    ``max``), in its own dtype — used to merge per-process metric
    accumulators. Without a process group: the identity."""
    x = np.asarray(x)
    if not initialized():
        return x
    if op not in ("sum", "max"):
        raise ValueError(f"allreduce_host_array: op {op!r} (sum or max)")
    t = _to_group(x)
    collective(dist.all_reduce, t,
               dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    return _from_group(t, x)


def barrier(name: str = "barrier") -> None:
    """Wait for every process (``name`` is for the reader: NCCL and gloo
    barriers are anonymous)."""
    if initialized():
        collective(dist.barrier)
