"""Structured TIM attention: counterpart of ``tim_tpu/ops/attention.py``.

Every token may attend to all context tokens (the first ``num_ctx``) and to
itself. The context tokens therefore run dense self-attention over the
context (an [F, F] block, plain PyTorch as it is a plain einsum in JAX),
and each query token a softmax over its F context keys plus its own key:
``query_block_attention``, the hand-written kernel on CUDA tensors. Exact
w.r.t. the reference's dense [S, S] mask (``dense_masked_attention``).

Deterministic only: attention dropout and the bf16-score ``fast_scores``
option are not ported yet.
"""

from __future__ import annotations

import math

import torch

from tim_tpu_torch.ops.query_block_attention import query_block_attention


def tim_attention_mask(seq_len: int, num_ctx: int) -> torch.Tensor:
    """Boolean [S, S] mask, True = allowed: context columns + diagonal."""
    allowed = torch.zeros((seq_len, seq_len), dtype=torch.bool)
    allowed[:, :num_ctx] = True
    return allowed | torch.eye(seq_len, dtype=torch.bool)


def tim_attention(q, k, v, num_ctx: int):
    """q, k, v: [B, H, S, dh], the first ``num_ctx`` positions context
    tokens. Scores and softmax in fp32; returns [B, H, S, dh] in q's
    dtype."""
    dt = q.dtype
    s, dh = q.shape[2], q.shape[3]
    # 1/sqrt(dh) rounded through the compute dtype, as the JAX path does
    scale = float(1.0 / torch.tensor(math.sqrt(dh)).to(dt))
    qc = q[:, :, :num_ctx] * scale
    kc, vc = k[:, :, :num_ctx], v[:, :, :num_ctx]

    ctx_w = torch.softmax(
        torch.matmul(qc.float(), kc.float().transpose(-1, -2)), dim=-1)
    ctx_out = torch.matmul(ctx_w.to(dt).float(), vc.float()).to(dt)
    if s == num_ctx:
        return ctx_out
    qry_out = query_block_attention(q[:, :, num_ctx:], kc, k[:, :, num_ctx:],
                                    vc, v[:, :, num_ctx:])
    return torch.cat([ctx_out, qry_out], dim=2)


def dense_masked_attention(q, k, v, allowed):
    """Reference-equivalent dense masked attention (the parity oracle).
    ``allowed``: boolean [S, S], True = may attend."""
    dt = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~allowed.to(q.device), float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w.to(dt).float(), v.float()).to(dt)
