"""Post-norm transformer encoder with structured TIM attention:
counterpart of ``tim_tpu/models/transformer.py``.

Parameter names follow torch's ``nn.TransformerEncoderLayer`` as the
reference checkpoints store them: ``self_attn.{in_proj_weight,
in_proj_bias,out_proj}``, ``norm1``, ``linear1``, ``linear2``, ``norm2``;
the int8 layers hold ``weight_q``/``weight_scale``/``bias`` under the same
names (``self_attn.in_proj`` for the packed q/k/v).
Layout is batch-first [B, S, C].

Training (a layer given a ``dropout_seed``): dropout of the encoder rate
on the attention weights (``ops.attention.tim_attention``), after the attention
before its residual, after the GELU, and after ``linear2`` before its
residual, each with ``dropout_bits``. A layer draws its masks from a
device generator it seeds from its own ``dropout_seed`` at the start of
its forward, so that ``remat`` (``torch.utils.checkpoint`` around each
layer), which runs the forward again in the backward, draws the same
masks.

On a model axis (``Encoder.shard``, the trunk's ``parallel.mesh.Mesh``
of ``model`` ranks, JAX's ``PARTITION_RULES``): each rank holds ``H /
model`` heads (three row blocks of the packed ``in_proj``) and runs
``tim_attention`` on them, ``out_proj`` is row-parallel (the ranks'
partial products summed in fp32, then the bias added and rounded once:
``models.common.row_parallel_linear``); ``linear1`` is column-parallel
(its GELU in the bias pass), ``linear2`` row-parallel. A head count or
FFN width that the model axis does not divide stays replicated. Each
dropout mask is drawn at the global shape and sliced (heads, FFN
columns, tokens: ``ops.dropout.BatchRows.along``). With
``sequence_parallel`` and S divisible by the model axis the post-LN
regions hold a token shard [B, S/model, D], as JAX's ``_shard_tokens``:
the row-parallel outputs reduce-scatter along S, the residual, dropout
and LayerNorm run on the shard, the inputs of ``in_proj`` and
``linear1`` all-gather along S, and the encoder gathers its output.
With ``fused`` the deterministic tail gathers ``linear1`` and
``linear2`` over the model ranks and launches the whole kernel on each.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tim_tpu_torch.models.common import (
    DENSE, TORCH_LINEAR, Int8Dense, LayerNorm, TorchLinear, exact_gelu,
    linear, uniform_)
from tim_tpu_torch.ops.attention import tim_attention
from tim_tpu_torch.ops.dropout import BatchRows, dropout, layer_generator
from tim_tpu_torch.ops.fused_post_attention import fused_post_attention


class SelfAttention(nn.Module):
    """Multi-head self-attention with the TIM context/self mask structure;
    q/k/v packed in ``in_proj_weight`` [3D, D] like torch's MHA. With
    ``quantized`` the packed projection is ``in_proj``, an ``Int8Dense``
    [3D, D] (per-output-row scales and one activation scale equal the JAX
    package's separate q/k/v int8 projections of the same input), and
    ``out_proj`` an ``Int8Dense``. ``fast_scores``: bf16 scores and softmax
    (``ops.attention.tim_attention``)."""

    def __init__(self, d_model: int, nhead: int, *, dtype: torch.dtype,
                 generator: torch.Generator, quantized: bool = False,
                 fast_scores: bool = False):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.dtype = dtype
        self.fast_scores = fast_scores
        if quantized:
            self.in_proj = Int8Dense(d_model, 3 * d_model, dtype=dtype)
            self.out_proj = Int8Dense(d_model, d_model, dtype=dtype)
            return
        # torch MHA init: xavier over the packed [3D, D] matrix, zero biases
        self.in_proj_weight = nn.Parameter(uniform_(
            torch.empty(3 * d_model, d_model),
            math.sqrt(6.0 / (4 * d_model)), generator))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = TorchLinear(d_model, d_model, dtype=dtype,
                                    generator=generator, rounding=DENSE,
                                    bias_value=0.0)

    def _project(self, x):
        if hasattr(self, "in_proj"):
            return self.in_proj(x)
        return linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype,
                      rounding=DENSE)

    def forward(self, x, num_ctx: int, shared_queries: bool = False, *,
                dropout_rate: float = 0.0, dropout_bits: int = 32,
                generator: Optional[torch.Generator] = None, reduce=None):
        """``generator``: the layer's dropout generator, given in training
        only (None: the deterministic attention). ``reduce``: this rank
        holds a slice of the heads, and ``out_proj`` is row-parallel, its
        partial products summed by ``reduce`` (module docstring)."""
        b, s, c = x.shape
        if shared_queries and s > num_ctx and b > 1:
            # Dense inference: the query tokens are identical across the
            # batch at this layer, so project one row and broadcast.
            yc = self._project(x[:, :num_ctx])
            yq = self._project(x[:1, num_ctx:])
            qkv = torch.cat([yc, yq.expand(b, -1, -1)], dim=1)
        else:
            qkv = self._project(x)
        dh = self.d_model // self.nhead
        heads = qkv.shape[-1] // (3 * dh)
        # [B, S, 3, H, dh] -> three strided [B, H, S, dh] views
        q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
        out = tim_attention(q, k, v, num_ctx, fast_scores=self.fast_scores,
                            deterministic=generator is None,
                            dropout_rate=dropout_rate,
                            dropout_bits=dropout_bits, generator=generator)
        out = out.transpose(1, 2).reshape(b, s, heads * dh)
        if reduce is None:  # int8 serving's Int8Dense takes no reduce
            return self.out_proj(out)
        return self.out_proj(out, reduce=reduce)


class EncoderLayer(nn.Module):
    """Post-norm block: x = LN(x + drop(attn(x))); x = LN(x + drop(ff(x))).
    With ``fused`` the tail after attention is ``fused_post_attention`` on
    deterministic calls (training keeps the unfused tail: the kernel has
    no backward); with ``quantized`` the four linears are ``Int8Dense``
    and ``fused`` is ignored, as in the JAX package (so int8 serving never
    launches the post-attention kernel). ``mesh`` (set by
    ``Encoder.shard``): the model axis, with ``heads_sharded`` and
    ``ffn_sharded`` saying which regions this rank holds a slice of."""

    mesh = None
    heads_sharded = ffn_sharded = False

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, *,
                 dtype: torch.dtype, fused: bool,
                 generator: torch.Generator, quantized: bool = False,
                 fast_scores: bool = False, dropout_rate: float = 0.1,
                 dropout_bits: int = 32):
        super().__init__()
        self.dtype = dtype
        self.dim_feedforward = dim_feedforward
        self.fused = fused and not quantized
        self.dropout_rate = dropout_rate
        self.dropout_bits = dropout_bits
        self.self_attn = SelfAttention(d_model, nhead, dtype=dtype,
                                       generator=generator,
                                       quantized=quantized,
                                       fast_scores=fast_scores)
        if quantized:
            self.linear1 = Int8Dense(d_model, dim_feedforward, dtype=dtype)
            self.linear2 = Int8Dense(dim_feedforward, d_model, dtype=dtype)
        else:
            self.linear1 = TorchLinear(d_model, dim_feedforward, dtype=dtype,
                                       generator=generator,
                                       rounding=TORCH_LINEAR)
            self.linear2 = TorchLinear(dim_feedforward, d_model, dtype=dtype,
                                       generator=generator,
                                       rounding=TORCH_LINEAR)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x, num_ctx: int, shared_queries: bool = False,
                dropout_seed: Optional[int] = None,
                dropout_rows: Optional[Tuple[int, int]] = None,
                tokens: Optional[Tuple[int, int]] = None):
        """``dropout_seed`` None: deterministic (inference); an int: the
        training route, every mask of the layer drawn from a device
        generator seeded with it (with ``dropout_rows``, this rank's rows
        of masks drawn for the global batch: ``ops.dropout.BatchRows``).
        ``tokens``: sequence parallelism, ``x`` is this rank's tokens
        ``start:`` of the ``total`` (start, total). One route with a model
        axis and without: each region entry (``_Regions``) returns its
        input where the layer holds the whole region."""
        deterministic = dropout_seed is None
        gen = None
        if not deterministic:
            gen = layer_generator(dropout_seed, x.device, dropout_rows)
        fused = self.fused and deterministic
        r = _Regions(self.mesh, tokens, gen, fused, x.shape[0])

        def drop(t, g):
            return dropout(t, self.dropout_rate, deterministic,
                           self.dropout_bits, g)

        heads = self.heads_sharded
        attn = self.self_attn(
            r.enter(x) if heads else r.all_tokens(x), num_ctx,
            shared_queries, dropout_rate=self.dropout_rate,
            dropout_bits=self.dropout_bits,
            generator=r.mask(1, self.self_attn.nhead) if heads else gen,
            reduce=r.reduce if heads else None)
        if fused:
            return self._fused_tail(x, attn, r)
        if not heads:
            attn = r.own_tokens(attn)
        tok = r.token_gen
        x = self.norm1(x + drop(attn, tok)).to(self.dtype)
        if isinstance(self.linear1, Int8Dense):
            # int8 serving: one model rank, the GELU after the linear
            h = self.linear2(drop(exact_gelu(self.linear1(x)), tok))
        else:   # the GELU in the linear's bias pass (JAX: TorchLinear, gelu)
            ffn = self.ffn_sharded
            h = self.linear1(r.enter(x) if ffn else x, gelu=True)
            h = drop(h, r.mask(2, self.dim_feedforward) if ffn else tok)
            h = self.linear2(h, reduce=r.reduce if ffn else None)
        return self.norm2(x + drop(h, tok)).to(self.dtype)

    def token_partial_parameters(self):
        """The replicated parameters that sequence parallelism applies to
        this rank's tokens only (their gradients are partial sums)."""
        params = [self.norm1.weight, self.norm1.bias, self.norm2.weight,
                  self.norm2.bias]
        if self.heads_sharded:
            params.append(self.self_attn.out_proj.bias)
        if self.ffn_sharded:
            params.append(self.linear2.bias)
        else:
            params += [self.linear1.weight, self.linear1.bias,
                       self.linear2.weight, self.linear2.bias]
        return params

    def _fused_tail(self, x, attn, r):
        """Kernel 2 over every token, on ``linear1`` and ``linear2``
        gathered over the model ranks where the layer holds slices of
        them; this rank's tokens of its output under sequence
        parallelism."""
        w1, b1, w2 = self.linear1.weight, self.linear1.bias, \
            self.linear2.weight
        if self.ffn_sharded:
            w1, b1, w2 = self.mesh.gather_params([(w1, 0, 1), (b1, 0, 1),
                                                  (w2, 1, 1)])
        out = fused_post_attention(
            r.all_tokens(x), attn, self.norm1.weight, self.norm1.bias, w1,
            b1, w2, self.linear2.bias, self.norm2.weight, self.norm2.bias)
        return r.own_tokens(out)


class _Regions:
    """How a layer's activations move between its regions on a model axis
    (module docstring); each entry returns its input where there is
    nothing to move (no model axis, no sequence parallelism)."""

    def __init__(self, mesh, tokens, gen, fused: bool, batch: int):
        self.mesh, self.gen, self.fused, self.batch = mesh, gen, fused, batch
        self.sp = tokens is not None
        # the generator of masks on the layer's token layout
        self.token_gen = self.mask(1, tokens[1]) if self.sp else gen

    def mask(self, dim: int, total: int):
        """The generator of a mask drawn at ``total`` along ``dim``, of
        which this rank holds its model slice."""
        if self.gen is None:
            return None
        gen = self.gen
        if not isinstance(gen, BatchRows):
            gen = BatchRows(gen, 0, self.batch)
        n = total // self.mesh.model_size
        return gen.along(dim, self.mesh.model_rank * n, total)

    def enter(self, t):
        """A sharded region's input, every token on every rank; its
        gradients are partial (summed back by the collective)."""
        return (self.mesh.gather_tokens(t) if self.sp
                else self.mesh.copy_to_model(t))

    def reduce(self, y):
        """The sum over the model ranks of a row-parallel output: this
        rank's tokens of it under sequence parallelism, unless the fused
        tail takes every token."""
        if self.sp and not self.fused:
            return self.mesh.scatter_tokens(y)
        return self.mesh.reduce_from_model(y)

    def all_tokens(self, t):
        """A replicated region's input with every token."""
        return self.mesh.gather_from_model(t, 1) if self.sp else t

    def own_tokens(self, t):
        """This rank's tokens of a replicated region's output."""
        return self.mesh.split_to_model(t, 1) if self.sp else t


class Encoder(nn.Module):
    """``num_layers`` post-norm layers (``layers.N``); with ``remat`` each
    layer runs under ``torch.utils.checkpoint`` while autograd records
    (its activations are recomputed in the backward)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int, *, dtype: torch.dtype, fused: bool,
                 generator: torch.Generator, quantized: bool = False,
                 fast_scores: bool = False, dropout_rate: float = 0.1,
                 dropout_bits: int = 32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.mesh = None
        self.sequence_parallel = False
        self.tokens_sharded = False     # the last forward's layout
        self.layers = nn.ModuleList([
            EncoderLayer(d_model, nhead, dim_feedforward, dtype=dtype,
                         fused=fused, generator=generator,
                         quantized=quantized, fast_scores=fast_scores,
                         dropout_rate=dropout_rate, dropout_bits=dropout_bits)
            for _ in range(num_layers)])

    def shard(self, mesh, sequence_parallel: bool, specs) -> None:
        """Run on ``mesh``'s model axis; ``specs`` (the trunk's
        ``shard_specs``, by name under ``layers.N``) say which regions are
        sharded. The parameters are sliced by the trunk."""
        self.mesh, self.sequence_parallel = mesh, sequence_parallel
        for i, layer in enumerate(self.layers):
            layer.mesh = mesh
            layer.heads_sharded = f"layers.{i}.self_attn.in_proj_weight" \
                in specs
            layer.ffn_sharded = f"layers.{i}.linear1.weight" in specs

    def token_partial_parameters(self):
        """The parameters whose gradients the last forward left partial
        per token shard (none unless it ran on token shards)."""
        if not self.tokens_sharded:
            return []
        return [p for layer in self.layers
                for p in layer.token_partial_parameters()]

    def forward(self, x, num_ctx: int, shared_queries: bool = False,
                dropout_seeds: Optional[Sequence[int]] = None,
                dropout_rows: Optional[Tuple[int, int]] = None):
        """``dropout_seeds``: one seed per layer (training), or None;
        ``dropout_rows``: see ``EncoderLayer.forward``. Under sequence
        parallelism (S divisible by the model axis) the layers run on this
        rank's tokens and the output is gathered."""
        tokens = None
        mesh = self.mesh
        self.tokens_sharded = (mesh is not None and self.sequence_parallel
                               and x.shape[1] % mesh.model_size == 0)
        if self.tokens_sharded:
            s = x.shape[1]
            x = mesh.split_to_model(x, 1)
            tokens = (mesh.model_rank * x.shape[1], s)
        for i, layer in enumerate(self.layers):
            # only layer 0 sees batch-identical query tokens
            args = (x, num_ctx, shared_queries and i == 0,
                    None if dropout_seeds is None else dropout_seeds[i],
                    dropout_rows, tokens)
            if self.remat and torch.is_grad_enabled():
                # the layer seeds its own generator, so the default
                # generators' states need not be kept for the replay
                x = checkpoint(layer, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(*args)
        if tokens is not None:
            x = mesh.gather_from_model(x, 1)
        return x
