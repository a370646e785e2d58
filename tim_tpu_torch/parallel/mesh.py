"""The data axis over processes: counterpart of ``tim_tpu/parallel/mesh.py``
for data parallelism on ``torch.distributed``.

The JAX package runs one SPMD program over a 2-D ``Mesh`` (``data`` x
``model``) and lets GSPMD insert the collectives. The port runs one
process per card (``parallel.multihost.initialize``), so its mesh is the
process group's data axis alone (``DataMesh``):

- every rank holds the whole model; ``shard_train_state`` broadcasts rank
  0's parameters, buffers and optimizer state;
- each rank draws its own 1/size of every global batch (``rows``);
- a train step sums its rank's share of the global loss's gradients over
  the ranks (``sync_gradients``: one bucketed ``all_reduce`` a dtype)
  before the optimizer's clip and non-finite skip, so that every rank
  takes the same update; ``all_reduce_sum`` and ``all_gather`` serve the
  steps' global counts and batches.

Without a process group the mesh has one rank and no collective runs:
the steps take the same path in one process as in many.
``shard_batch`` is the device move and ``host_local_rows`` the identity.
Not here: ``PARTITION_RULES`` and ``param_shardings`` (tensor
parallelism, ``ROADMAP.md`` queue 1 item 8), ``put_ids`` (TPU machinery:
the banked paths split their window ids by rank) and
``prefetch_to_device``'s ``jax.device_put`` (batches move through pinned
memory, ``data.device_bank.host_to_device``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tim_tpu_torch.data.device_bank import host_to_device
from tim_tpu_torch.parallel.multihost import (
    collective, initialized, process_count, process_index)

TENSOR_PARALLEL = ("ROADMAP.md, queue 1 item 8: tensor and sequence "
                   "parallelism")


class DataMesh:
    """The data axis of every process in the group, one card each."""

    axis_names = ("data", "model")

    def __init__(self):
        self.distributed = initialized()
        self.size = process_count()
        self.rank = process_index()

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size, "model": 1}

    def rows(self, local: int) -> Tuple[int, int]:
        """(first row, rows in all) of this rank's ``local`` rows in the
        global batch: the ranks' batches in rank order."""
        return self.rank * local, self.size * local

    def local_batch(self, batch_size: int) -> int:
        """This rank's share of a global batch of ``batch_size``."""
        if batch_size % self.size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{self.size} processes")
        return batch_size // self.size

    def share(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        local = self.local_batch(batch_size)
        return slice(self.rank * local, (self.rank + 1) * local)

    @property
    def shard_args(self) -> Dict[str, int]:
        """``data.dataset.batch_iterator``'s arguments for this rank's
        shard of a split."""
        return {"num_shards": self.size, "shard_index": self.rank}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.distributed:
            collective(dist.all_reduce, t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) concatenated along
        axis 0 in rank order."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        collective(dist.all_gather, parts, t.contiguous())
        return torch.cat(parts)

    def _bucketed(self, tensors: Sequence[torch.Tensor], op) -> None:
        """``op(flat)`` on one flat copy of the tensors of each dtype, the
        result copied back in place by one ``_foreach_copy_`` (a copy a
        tensor costs a launch each; bool travels as uint8)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, ts in by_dtype.items():
            flat = torch.cat([t.reshape(-1) for t in ts])
            if dtype == torch.bool:
                flat = flat.to(torch.uint8)
            op(flat)
            torch._foreach_copy_(ts, [
                piece.view(t.shape).to(dtype)
                for t, piece in zip(ts, flat.split([t.numel() for t in ts]))])

    def sync_gradients(self, params: Sequence[torch.nn.Parameter],
                       shares: Sequence[torch.Tensor] = ()
                       ) -> List[torch.Tensor]:
        """Sum the gradients of ``params`` and the 0-d ``shares`` (each
        rank's share of a loss, as fp32) over the ranks: one
        ``all_reduce`` a dtype. A parameter without a gradient gets zeros
        (the optimizer counts a missing gradient as zeros). Returns the
        summed shares."""
        shares = [s.detach().float().reshape(1) for s in shares]
        if not self.distributed:
            return [s[0] for s in shares]
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        self._bucketed(grads + shares,
                       lambda flat: collective(dist.all_reduce, flat))
        return [s[0] for s in shares]

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place."""
        if self.distributed:
            self._bucketed(list(tensors),
                           lambda flat: collective(dist.broadcast, flat, 0))


def make_mesh(data: int = -1, model: int = 1) -> DataMesh:
    """The data axis over the process group. ``model`` must be 1 (tensor
    parallelism is not ported) and ``data`` -1 or the process count: the
    port runs one process per card."""
    if model != 1:
        raise NotImplementedError(
            f"mesh model axis {model}: tensor parallelism is not ported "
            f"yet ({TENSOR_PARALLEL})")
    world = process_count()
    if data not in (-1, world):
        raise ValueError(
            f"mesh data axis {data}: the port runs one process per card, "
            f"so the data axis is the process count ({world}) or -1")
    return DataMesh()


def shard_train_state(state, mesh: DataMesh):
    """Rank 0's parameters, buffers, optimizer state and normaliser on
    every rank (in place); returns ``state``."""
    tensors = list(state.model.state_dict().values())
    opt = state.optimizer
    for p_state in opt.state.values():
        tensors += [v for v in p_state.values()
                    if isinstance(v, torch.Tensor)]
    tensors += list(getattr(opt, "counters", {}).values())
    tensors.append(state.normaliser)
    mesh.broadcast(tensors)
    return state


def shard_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A host batch's arrays on ``device`` (this rank's rows are already
    its own)."""
    return {k: host_to_device(torch.from_numpy(np.asarray(v)), device)
            for k, v in batch.items()}


def host_local_rows(x):
    """This rank's rows of a batch output: the output itself."""
    return x
