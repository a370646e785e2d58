"""The data and model axes over processes: counterpart of
``tim_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one SPMD program over a 2-D ``Mesh`` (``data`` x
``model``) and lets GSPMD insert the collectives. The port runs one
process per card (``parallel.multihost.initialize``) and lays the
processes out as ``mesh_utils.create_device_mesh((data, model))`` lays out
devices: global rank ``data_index * model + model_index``, so that a model
group is ``model`` consecutive ranks and a data group the ranks of one
model index (``Mesh``).

Data axis:

- each data group's ranks draw their own 1/data of every global batch
  (``rows``, ``share``, ``shard_args``); the ``model`` ranks of one data
  index read the same rows and draw the same global masks;
- a train step sums its rank's share of the global loss's gradients over
  the data group (``sync_gradients``: one bucketed ``all_reduce`` a
  dtype) before the optimizer's clip and non-finite skip;
  ``all_reduce_sum``, ``all_gather`` and the host helpers serve the
  steps' global counts and batches and the runners' sums and dumps.

Model axis (Megatron-style tensor parallelism, JAX's ``PARTITION_RULES``
under the reference's torch names): the model ranks hold the encoder's
heads, its FFN hidden units and the divisible class heads' classes in
``model`` shards (``shard_specs``); the layers move activations between
the regions with ``copy_to_model`` (identity, ``all_reduce`` backward),
``reduce_from_model`` (``all_reduce``, identity backward),
``gather_from_model`` (``all_gather``, slice backward), and for sequence
parallelism ``split_to_model`` (slice, ``all_gather`` backward),
``scatter_tokens`` (``reduce_scatter`` along S, ``all_gather`` backward)
and ``gather_tokens`` (``all_gather`` along S, ``reduce_scatter``
backward). Every collective goes through ``multihost.collective``.

Without a process group the mesh has one rank and no collective runs:
the steps take the same path in one process as in many; a group of one
rank runs the data axis's collectives over it. ``shard_batch`` is the
device move and ``host_local_rows`` the identity. Not here: ``put_ids``
(TPU machinery: the banked paths split their window ids by rank) and
``prefetch_to_device``'s ``jax.device_put`` (batches move through pinned
memory, ``data.device_bank.host_to_device``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tim_tpu_torch.data.device_bank import host_to_device
from tim_tpu_torch.parallel import multihost
from tim_tpu_torch.parallel.multihost import (
    collective, initialized, process_count, process_index)

# (state-dict name pattern, partition spec) -- first match wins; default
# replicated. A spec names the mesh axis of each dimension of the torch
# tensor ([out, in] for a weight), as JAX's PartitionSpec does of the flax
# kernel ([in, out]):
# - attention heads: q|k|v kernel P(None, model) and bias P(model) are the
#   rows of each third of the packed in_proj ([3D, D]: ``PACKED``), out
#   kernel P(model, None) the input columns of out_proj;
# - feed-forward: linear1 column-parallel, linear2 row-parallel;
# - classifier heads: column-parallel over classes.
PARTITION_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*self_attn\.in_proj_weight$", ("model", None)),
    (r".*self_attn\.in_proj_bias$", ("model",)),
    (r".*self_attn\.out_proj\.weight$", (None, "model")),
    (r".*linear1\.weight$", ("model", None)),
    (r".*linear1\.bias$", ("model",)),
    (r".*linear2\.weight$", (None, "model")),
    (r".*cls_head\.[^.]+\.weight$", ("model", None)),
    (r".*cls_head\.[^.]+\.bias$", ("model",)),
)
# names whose sharded dimension packs equal blocks (q, k, v), each sharded
PACKED = (r".*self_attn\.in_proj_(weight|bias)$", 3)


def _spec_for(name: str) -> Tuple[Optional[str], ...]:
    for pattern, spec in PARTITION_RULES:
        if re.match(pattern, name):
            return spec
    return ()


def _blocks(name: str) -> int:
    return PACKED[1] if re.match(PACKED[0], name) else 1


def _divisible_spec(spec, shape, model: int, blocks: int = 1):
    """Drop sharding on any dim the mesh's model axis doesn't divide (in
    each of ``blocks`` packed blocks): e.g. a 97-way verb head can't
    split over model=2, so it stays replicated."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
        else:
            out.append(axis if shape[i] % (blocks * model) == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_specs(named_shapes: Mapping[str, Sequence[int]], model: int
                ) -> Dict[str, Tuple[int, int]]:
    """How ``PARTITION_RULES`` shard each parameter over a model axis of
    ``model`` (JAX's ``param_shardings``): name -> (sharded dim, packed
    blocks); replicated names are left out."""
    out = {}
    for name, shape in named_shapes.items():
        blocks = _blocks(name)
        spec = _divisible_spec(_spec_for(name), tuple(shape), model, blocks)
        if "model" in spec:
            out[name] = (spec.index("model"), blocks)
    return out


def _groups(ranks_by_group: Sequence[Sequence[int]], rank: int):
    """``dist.new_group`` of every list (every rank creates every group,
    in one order); returns this rank's (None: the whole world)."""
    mine = None
    for ranks in ranks_by_group:
        if len(ranks) == dist.get_world_size():
            return None
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = group
    return mine


class Mesh:
    """The data and model axes of every process in the group, one card
    each (module docstring). ``model`` must divide the process count."""

    axis_names = ("data", "model")

    def __init__(self, model: int = 1):
        self.distributed = initialized()
        world = process_count()
        if model < 1 or world % model:
            raise ValueError(f"mesh model axis {model}: it must divide the "
                             f"process count ({world})")
        rank = process_index()
        self.model_size, self.data_size = model, world // model
        self.data_rank, self.model_rank = divmod(rank, model)
        self.model_group = self.data_group = None
        if model > 1:
            self.model_group = _groups(
                [range(d * model, (d + 1) * model)
                 for d in range(self.data_size)], rank)
            if self.data_size > 1:
                self.data_group = _groups(
                    [range(m, world, model) for m in range(model)], rank)
        # the data axis's collectives run in any group (a group of one
        # rank too) unless the model axis takes every rank
        self.data_collectives = self.distributed and (
            model == 1 or self.data_size > 1)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}

    # -- the data axis --------------------------------------------------
    def rows(self, local: int) -> Tuple[int, int]:
        """(first row, rows in all) of this rank's ``local`` rows in the
        global batch: the data ranks' batches in data-rank order."""
        return self.data_rank * local, self.data_size * local

    def local_batch(self, batch_size: int) -> int:
        """This rank's share of a global batch of ``batch_size``."""
        if batch_size % self.data_size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the data axis ({self.data_size} groups)")
        return batch_size // self.data_size

    def share(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        local = self.local_batch(batch_size)
        return slice(self.data_rank * local, (self.data_rank + 1) * local)

    @property
    def shard_args(self) -> Dict[str, int]:
        """``data.dataset.batch_iterator``'s arguments for this rank's
        shard of a split."""
        return {"num_shards": self.data_size, "shard_index": self.data_rank}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group, in place."""
        if self.data_collectives:
            collective(dist.all_reduce, t, group=self.data_group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (the same shape on each) concatenated
        along axis 0 in data-rank order."""
        if not self.data_collectives:
            return t
        parts = [torch.empty_like(t) for _ in range(self.data_size)]
        collective(dist.all_gather, parts, t.contiguous(),
                   group=self.data_group)
        return torch.cat(parts)

    def allgather_host_arrays(self, x: np.ndarray) -> np.ndarray:
        """``multihost.allgather_host_arrays`` over the data group."""
        if not self.data_collectives:
            return np.asarray(x)
        return multihost.allgather_host_arrays(x, group=self.data_group)

    def allreduce_host_array(self, x: np.ndarray, op: str = "sum"
                             ) -> np.ndarray:
        """``multihost.allreduce_host_array`` over the data group."""
        if not self.data_collectives:
            return np.asarray(x)
        return multihost.allreduce_host_array(x, op, group=self.data_group)

    @staticmethod
    def _bucketed(tensors: Sequence[torch.Tensor], op) -> None:
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

    @staticmethod
    def _grads(params: Sequence[torch.nn.Parameter]) -> List[torch.Tensor]:
        """The gradients of ``params``, zeros where a parameter has none
        (the optimizer counts a missing gradient as zeros)."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in params]

    def sync_gradients(self, params: Sequence[torch.nn.Parameter],
                       shares: Sequence[torch.Tensor] = ()
                       ) -> List[torch.Tensor]:
        """Sum the gradients of ``params`` and the 0-d ``shares`` (each
        rank's share of a loss, as fp32) over the data group: one
        ``all_reduce`` a dtype. Returns the summed shares."""
        shares = [s.detach().float().reshape(1) for s in shares]
        if not self.data_collectives:
            return [s[0] for s in shares]
        self._bucketed(self._grads(params) + shares, lambda flat: collective(
            dist.all_reduce, flat, group=self.data_group))
        return [s[0] for s in shares]

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place."""
        if self.distributed and tensors:
            self._bucketed(list(tensors),
                           lambda flat: collective(dist.broadcast, flat, 0))

    def broadcast_data(self, tensors: Sequence[torch.Tensor]) -> None:
        """The values of ``tensors`` on data rank 0 of this rank's data
        group (global rank ``model_rank``) on the group's every rank."""
        if self.data_collectives and tensors:
            self._bucketed(list(tensors), lambda flat: collective(
                dist.broadcast, flat, self.model_rank, group=self.data_group))

    # -- the model axis -------------------------------------------------
    def sum_model_gradients(self, params: Sequence[torch.nn.Parameter]
                            ) -> None:
        """Sum the gradients of ``params`` over the model group (one
        ``all_reduce`` a dtype): replicated parameters that each rank
        applied to its token shard only."""
        if self.model_size > 1 and params:
            self._bucketed(self._grads(params), lambda flat: collective(
                dist.all_reduce, flat, group=self.model_group))

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group, in place."""
        if self.model_size > 1:
            collective(dist.all_reduce, t, group=self.model_group)
        return t

    def model_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' ``t`` concatenated along ``dim`` in
        model-rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.model_size)]
        collective(dist.all_gather, parts, t, group=self.model_group)
        return torch.cat(parts, dim)

    def model_reduce_scatter(self, t: torch.Tensor, dim: int
                             ) -> torch.Tensor:
        """``t`` summed over the model group, this rank's ``1/model`` of
        it along ``dim``."""
        parts = [p.contiguous() for p in t.chunk(self.model_size, dim)]
        out = torch.empty_like(parts[self.model_rank])
        collective(dist.reduce_scatter, out, parts, group=self.model_group)
        return out

    def model_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's ``1/model`` of ``t`` along ``dim``."""
        n = t.shape[dim] // self.model_size
        return t.narrow(dim, self.model_rank * n, n)

    def copy_to_model(self, x):
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x):
        return _ReduceFromModel.apply(x, self)

    def gather_from_model(self, x, dim: int):
        return _GatherFromModel.apply(x, self, dim)

    def split_to_model(self, x, dim: int):
        return _SplitToModel.apply(x, self, dim)

    def scatter_tokens(self, x):
        """Partial [B, S, D] -> their sum's token shard [B, S/model, D]."""
        return _ScatterTokens.apply(x, self)

    def gather_tokens(self, x):
        """Token shards [B, S/model, D] -> [B, S, D] on every model rank,
        whose consumer's gradients are partial (a column-parallel layer):
        the backward sums them and keeps this rank's tokens."""
        return _GatherTokens.apply(x, self)

    def local_slice(self, t: torch.Tensor, dim: int, blocks: int = 1
                    ) -> torch.Tensor:
        """This model rank's shard of a whole tensor: its ``1/model`` along
        ``dim`` of each of ``blocks`` equal blocks (q, k, v: 3)."""
        return torch.cat([b.chunk(self.model_size, dim)[self.model_rank]
                          for b in t.chunk(blocks, dim)], dim)

    def gather_params(self, shards: Sequence[Tuple[torch.Tensor, int, int]]
                      ) -> List[torch.Tensor]:
        """The whole tensor of each (shard, dim, blocks) (the inverse of
        ``local_slice`` over the model ranks), all in one
        ``all_gather``."""
        flat = torch.cat([t.reshape(-1) for t, _, _ in shards])
        parts = [torch.empty_like(flat) for _ in range(self.model_size)]
        collective(dist.all_gather, parts, flat, group=self.model_group)
        sizes = [t.numel() for t, _, _ in shards]
        pieces = [p.split(sizes) for p in parts]
        out = []
        for i, (t, dim, blocks) in enumerate(shards):
            ranks = [piece[i].view(t.shape).chunk(blocks, dim)
                     for piece in pieces]
            out.append(torch.cat([r[b] for b in range(blocks)
                                  for r in ranks], dim))
        return out


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the model ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the model ranks' partial ``x``; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(
            x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' ``x`` concatenated along ``dim``; the backward
    keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_slice(g, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    """This rank's slice of a replicated ``x`` along ``dim``; the backward
    gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_slice(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_gather(g, ctx.dim), None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.model_reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_gather(g, 1), None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.model_all_gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_reduce_scatter(g, 1), None


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The process group as a ``data`` x ``model`` mesh: ``model`` must
    divide the process count and ``data`` be -1 or the count over
    ``model`` (one process per card)."""
    mesh = Mesh(model)
    if data not in (-1, mesh.data_size):
        raise ValueError(
            f"mesh data axis {data}: the port runs one process per card, "
            f"so the data axis is the process count over the model axis "
            f"({mesh.data_size}) or -1")
    return mesh


def _sharded(state) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(replicated, sharded) tensors of a train state: parameters,
    buffers, optimizer moments, counters, normaliser."""
    model, opt = state.model, state.optimizer
    specs = getattr(model, "shard_specs", {})
    replicated, sharded = [], []
    by_param = {}
    for name, t in model.state_dict(keep_vars=True).items():
        (sharded if name in specs else replicated).append(t.data)
        by_param[id(t)] = name in specs
    for p, p_state in opt.state.items():
        for v in p_state.values():
            if isinstance(v, torch.Tensor):
                (sharded if by_param.get(id(p)) else replicated).append(v)
    replicated += list(getattr(opt, "counters", {}).values())
    replicated.append(state.normaliser)
    return replicated, sharded


def shard_train_state(state, mesh: Mesh):
    """Rank 0's parameters, buffers, optimizer state and normaliser on
    every rank (in place); the sharded parameters and their moments from
    data rank 0 of each model index, so that each rank keeps its own
    slices. Returns ``state``."""
    replicated, sharded = _sharded(state)
    mesh.broadcast(replicated)
    mesh.broadcast_data(sharded)
    return state


def shard_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A host batch's arrays on ``device`` (this rank's rows are already
    its own)."""
    return {k: host_to_device(torch.from_numpy(np.asarray(v)), device)
            for k, v in batch.items()}


def host_local_rows(x):
    """This rank's rows of a batch output: the output itself."""
    return x
