"""Structured TIM attention: counterpart of ``tim_tpu/ops/attention.py``.

Every token may attend to all context tokens (the first ``num_ctx``) and to
itself. The context tokens therefore run dense self-attention over the
context (an [F, F] block, plain PyTorch as it is a plain einsum in JAX),
and each query token a softmax over its F context keys plus its own key:
``query_block_attention``, the hand-written kernel on CUDA tensors. Exact
w.r.t. the reference's dense [S, S] mask (``dense_masked_attention``).

``fast_scores`` (the serving option of the same name): scores and softmax
in bf16, every elementwise step rounded to bf16 as the JAX einsum path
rounds it, the value sums still fp32. JAX computes that path in XLA and
never reaches its Pallas query-block kernel, so here it stays plain
PyTorch and the query-block kernel is not launched.

Deterministic only: attention dropout is not ported yet.
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


def _softmax_bf16(scores):
    """``jax.nn.softmax`` over bf16 scores: max, exp, sum and divide each
    round to bf16."""
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _fast_scores_attention(qc, kc, vc, qq, kq, vq, scale):
    """The einsum path of ``tim_tpu/ops/attention.py::tim_attention`` with
    ``score_dtype=bfloat16``: scores rounded to bf16 after their fp32 sums,
    bf16 softmax, fp32 value sums rounded to the compute dtype. The
    compute dtype is fp32 or bf16."""
    dt, sdt = qc.dtype, torch.bfloat16

    # products in the compute dtype: a bf16 GEMM sums in fp32 and rounds
    # once, as the fp32 product cast to bf16 would
    def scores(a, b):
        return torch.matmul(a, b.transpose(-1, -2)).to(sdt)

    def values(w, v):
        return torch.matmul(w.to(dt), v)

    ctx_out = values(_softmax_bf16(scores(qc, kc)), vc)
    if qq is None:
        return ctx_out, None
    qq = qq * scale
    qry_scores = scores(qq, kc)                                # [B,H,Nq,F]
    self_scores = (qq.to(sdt) * kq.to(sdt)).sum(-1, keepdim=True)
    m = torch.maximum(qry_scores.amax(-1, keepdim=True), self_scores)
    e_ctx = torch.exp(qry_scores - m)
    e_self = torch.exp(self_scores - m)
    denom = e_ctx.sum(-1, keepdim=True) + e_self
    qry_out = values(e_ctx / denom, vc) + (e_self / denom).to(dt) * vq
    return ctx_out, qry_out


def tim_attention(q, k, v, num_ctx: int, *, fast_scores: bool = False):
    """q, k, v: [B, H, S, dh], the first ``num_ctx`` positions context
    tokens. Scores and softmax in fp32 (bf16 with ``fast_scores``);
    returns [B, H, S, dh] in q's dtype."""
    dt = q.dtype
    s, dh = q.shape[2], q.shape[3]
    # 1/sqrt(dh) rounded through the compute dtype, as the JAX path does
    scale = float(1.0 / torch.tensor(math.sqrt(dh)).to(dt))
    qc = q[:, :, :num_ctx] * scale
    kc, vc = k[:, :, :num_ctx], v[:, :, :num_ctx]

    if fast_scores:
        rest = (None, None, None) if s == num_ctx else (
            q[:, :, num_ctx:], k[:, :, num_ctx:], v[:, :, num_ctx:])
        ctx_out, qry_out = _fast_scores_attention(qc, kc, vc, *rest, scale)
        if qry_out is None:
            return ctx_out
        return torch.cat([ctx_out, qry_out], dim=2)

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
