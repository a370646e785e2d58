"""Post-norm transformer encoder with structured TIM attention:
counterpart of ``tim_tpu/models/transformer.py`` (deterministic path).

Parameter names follow torch's ``nn.TransformerEncoderLayer`` as the
reference checkpoints store them: ``self_attn.{in_proj_weight,
in_proj_bias,out_proj}``, ``norm1``, ``linear1``, ``linear2``, ``norm2``;
the int8 layers hold ``weight_q``/``weight_scale``/``bias`` under the same
names (``self_attn.in_proj`` for the packed q/k/v).
Layout is batch-first [B, S, C].
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tim_tpu_torch.models.common import (
    Int8Dense, LayerNorm, TorchLinear, exact_gelu, linear, uniform_)
from tim_tpu_torch.ops.attention import tim_attention
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
                                    generator=generator, bias_value=0.0)

    def _project(self, x):
        if hasattr(self, "in_proj"):
            return self.in_proj(x)
        return linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype)

    def forward(self, x, num_ctx: int, shared_queries: bool = False):
        b, s, c = x.shape
        if shared_queries and s > num_ctx and b > 1:
            # Dense inference: the query tokens are identical across the
            # batch at this layer, so project one row and broadcast.
            yc = self._project(x[:, :num_ctx])
            yq = self._project(x[:1, num_ctx:])
            qkv = torch.cat([yc, yq.expand(b, -1, -1)], dim=1)
        else:
            qkv = self._project(x)
        # [B, S, 3, H, dh] -> three strided [B, H, S, dh] views
        q, k, v = qkv.view(b, s, 3, self.nhead, c // self.nhead).permute(
            2, 0, 3, 1, 4)
        out = tim_attention(q, k, v, num_ctx, fast_scores=self.fast_scores)
        out = out.transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm block: x = LN(x + attn(x)); x = LN(x + ff(x)). With
    ``fused`` the tail after attention is ``fused_post_attention``; with
    ``quantized`` the four linears are ``Int8Dense`` and ``fused`` is
    ignored, as in the JAX package (so int8 serving never launches the
    post-attention kernel)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, *,
                 dtype: torch.dtype, fused: bool,
                 generator: torch.Generator, quantized: bool = False,
                 fast_scores: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused = fused and not quantized
        self.self_attn = SelfAttention(d_model, nhead, dtype=dtype,
                                       generator=generator,
                                       quantized=quantized,
                                       fast_scores=fast_scores)
        if quantized:
            self.linear1 = Int8Dense(d_model, dim_feedforward, dtype=dtype)
            self.linear2 = Int8Dense(dim_feedforward, d_model, dtype=dtype)
        else:
            self.linear1 = TorchLinear(d_model, dim_feedforward, dtype=dtype,
                                       generator=generator)
            self.linear2 = TorchLinear(dim_feedforward, d_model, dtype=dtype,
                                       generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x, num_ctx: int, shared_queries: bool = False):
        attn = self.self_attn(x, num_ctx, shared_queries)
        if self.fused:
            return fused_post_attention(
                x, attn, self.norm1.weight, self.norm1.bias,
                self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias,
                self.norm2.weight, self.norm2.bias)
        x = self.norm1(x + attn).to(self.dtype)
        h = self.linear2(exact_gelu(self.linear1(x)))
        return self.norm2(x + h).to(self.dtype)


class Encoder(nn.Module):
    """``num_layers`` post-norm layers (``layers.N``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int, *, dtype: torch.dtype, fused: bool,
                 generator: torch.Generator, quantized: bool = False,
                 fast_scores: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            EncoderLayer(d_model, nhead, dim_feedforward, dtype=dtype,
                         fused=fused, generator=generator,
                         quantized=quantized, fast_scores=fast_scores)
            for _ in range(num_layers)])

    def forward(self, x, num_ctx: int, shared_queries: bool = False):
        for i, layer in enumerate(self.layers):
            # only layer 0 sees batch-identical query tokens
            x = layer(x, num_ctx, shared_queries and i == 0)
        return x
