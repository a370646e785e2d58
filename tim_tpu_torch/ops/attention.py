"""Structured TIM attention: counterpart of ``tim_tpu/ops/attention.py``.

Every token may attend to all context tokens (the first ``num_ctx``) and to
itself. The context tokens therefore run dense self-attention over the
context (an [F, F] block, plain PyTorch as it is a plain einsum in JAX),
and each query token a softmax over its F context keys plus its own key.
Exact w.r.t. the reference's dense [S, S] mask (``dense_masked_attention``).

Three routes, as in the JAX package:

- deterministic, fp32 scores: the query block is ``query_block_attention``,
  the hand-written kernel on CUDA tensors (it has no backward);
- training (``deterministic=False``): JAX's einsum path in plain PyTorch,
  fp32 scores, with dropout on the context weights and on the query
  block's context and self weights, each its own draw, after the softmax
  (torch MHA's placement); autograd takes the gradient. It never reaches
  the kernel, whatever the rate, as JAX's ``deterministic`` rule;
- ``fast_scores`` (the serving option of the same name): the einsum path
  with scores and softmax in bf16, every elementwise step rounded to bf16
  as the JAX path rounds it, the value sums still fp32. JAX never reaches
  its Pallas kernel there, so the kernel is not launched either.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from tim_tpu_torch.ops.dropout import dropout
from tim_tpu_torch.ops.query_block_attention import query_block_attention


def tim_attention_mask(seq_len: int, num_ctx: int) -> torch.Tensor:
    """Boolean [S, S] mask, True = allowed: context columns + diagonal."""
    allowed = torch.zeros((seq_len, seq_len), dtype=torch.bool)
    allowed[:, :num_ctx] = True
    return allowed | torch.eye(seq_len, dtype=torch.bool)


def _softmax(scores):
    """``jax.nn.softmax``: exp(x - max) / sum, each step in the scores'
    dtype (so in bf16 each rounds to bf16)."""
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _einsum_attention(qc, kc, vc, rest, scale, sdt: torch.dtype,
                      drop: Callable):
    """The einsum path of ``tim_tpu/ops/attention.py::tim_attention`` with
    scores in ``sdt``: scores summed in fp32 and rounded to ``sdt`` (bf16
    products in the compute dtype: a bf16 GEMM sums in fp32 and rounds
    once, as the fp32 product cast to bf16 would), the softmax in ``sdt``,
    ``drop`` applied to the weights, fp32 value sums rounded to the
    compute dtype. ``rest``: (qq, kq, vq) of the query block, or None.
    Returns (ctx_out, qry_out or None)."""
    dt = qc.dtype
    opd = dt if sdt == torch.bfloat16 else torch.float32

    def scores(a, b):
        return torch.matmul(a.to(opd), b.to(opd).transpose(-1, -2)).to(sdt)

    def values(w, v):
        return torch.matmul(w.to(dt), v)

    ctx_out = values(drop(_softmax(scores(qc, kc))), vc)
    if rest is None:
        return ctx_out, None
    qq, kq, vq = rest
    qq = qq * scale
    qry_scores = scores(qq, kc)                                # [B,H,Nq,F]
    self_scores = (qq.to(sdt) * kq.to(sdt)).sum(-1, keepdim=True)
    # the joint softmax over [context ‖ self] without concatenating
    m = torch.maximum(qry_scores.amax(-1, keepdim=True), self_scores)
    e_ctx = torch.exp(qry_scores - m)
    e_self = torch.exp(self_scores - m)
    denom = e_ctx.sum(-1, keepdim=True) + e_self
    w_ctx = drop(e_ctx / denom)
    w_self = drop(e_self / denom)
    return ctx_out, values(w_ctx, vc) + w_self.to(dt) * vq


def tim_attention(q, k, v, num_ctx: int, *, fast_scores: bool = False,
                  deterministic: bool = True, dropout_rate: float = 0.0,
                  dropout_bits: int = 32,
                  generator: Optional[torch.Generator] = None):
    """q, k, v: [B, H, S, dh], the first ``num_ctx`` positions context
    tokens. Scores and softmax in fp32 (bf16 with ``fast_scores``);
    returns [B, H, S, dh] in q's dtype. With ``deterministic=False`` the
    training route: dropout of ``dropout_rate`` (``dropout_bits``: 32
    Bernoulli, 8 the uint8 mask) from ``generator`` on the three weight
    tensors, in the order context, query-context, query-self."""
    dt = q.dtype
    s, dh = q.shape[2], q.shape[3]
    # 1/sqrt(dh) rounded through the compute dtype, as the JAX path does
    scale = float(1.0 / torch.tensor(math.sqrt(dh)).to(dt))
    qc = q[:, :, :num_ctx] * scale
    kc, vc = k[:, :, :num_ctx], v[:, :, :num_ctx]
    rest = None if s == num_ctx else (
        q[:, :, num_ctx:], k[:, :, num_ctx:], v[:, :, num_ctx:])

    if fast_scores or not deterministic:
        def drop(w):
            return dropout(w, dropout_rate, deterministic, dropout_bits,
                           generator)

        sdt = torch.bfloat16 if fast_scores else torch.float32
        ctx_out, qry_out = _einsum_attention(qc, kc, vc, rest, scale, sdt,
                                             drop)
        if qry_out is None:
            return ctx_out
        return torch.cat([ctx_out, qry_out], dim=2)

    ctx_w = torch.softmax(
        torch.matmul(qc.float(), kc.float().transpose(-1, -2)), dim=-1)
    ctx_out = torch.matmul(ctx_w.to(dt).float(), vc.float()).to(dt)
    if rest is None:
        return ctx_out
    qry_out = query_block_attention(rest[0], kc, rest[1], vc, rest[2])
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
