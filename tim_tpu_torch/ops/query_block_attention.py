"""TIM query-block attention: counterpart of ``tim_tpu/ops/pallas_attention.py``.

Each interval-query token attends to the F context keys plus exactly one
more key, its own: a softmax over F+1 scores scaled by 1/sqrt(dh), then the
weighted sum of the context values and its own value. Internals are fp32,
the output is in the input dtype.

``query_block_attention`` launches the CUDA kernel
(``csrc/query_block_attention.cu``: tensor cores in bf16 at head dims 32,
64 and 128, CUDA cores in fp32 and at head dim 256) for CUDA tensors and
runs ``query_block_attention_plain``, the same function in plain
PyTorch, for CPU tensors. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tim_tpu_torch import _build

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)
# tim_query_block_attention(qq, kc, kq, vc, vq, out, strides, b, h, nq, f,
# dh, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])


def query_block_attention_plain(qq, kc, kq, vc, vq):
    """The body of ``_query_block_kernel`` in plain PyTorch.

    qq/kq/vq: [B, H, Nq, dh]; kc/vc: [B, H, F, dh]. Returns [B, H, Nq, dh]
    in qq's dtype."""
    scale = 1.0 / math.sqrt(qq.shape[-1])
    q = qq.float() * scale
    scores = torch.matmul(q, kc.float().transpose(-1, -2))      # [B,H,Nq,F]
    self_scores = (q * kq.float()).sum(-1, keepdim=True)         # [B,H,Nq,1]
    m = torch.maximum(scores.amax(-1, keepdim=True), self_scores)
    e_ctx = torch.exp(scores - m)
    e_self = torch.exp(self_scores - m)
    denom = e_ctx.sum(-1, keepdim=True) + e_self
    out = torch.matmul(e_ctx / denom, vc.float()) + (e_self / denom) * vq.float()
    return out.to(qq.dtype)


def _check(qq, kc, kq, vc, vq):
    b, h, nq, dh = qq.shape
    f = kc.shape[2]
    for name, t, rows in (("qq", qq, nq), ("kc", kc, f), ("kq", kq, nq),
                          ("vc", vc, f), ("vq", vq, nq)):
        if t.device != qq.device or t.dtype != qq.dtype:
            raise ValueError(f"query_block_attention: {name} is "
                             f"{t.dtype} on {t.device}, qq is {qq.dtype} "
                             f"on {qq.device}")
        if tuple(t.shape) != (b, h, rows, dh):
            raise ValueError(f"query_block_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(b, h, rows, dh)}")
        if t.stride(3) != 1:
            raise ValueError(f"query_block_attention: {name} must be "
                             f"contiguous in its last dim")
    if qq.dtype not in _DTYPES:
        raise ValueError(f"query_block_attention: dtype {qq.dtype} not in "
                         f"{_DTYPES}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"query_block_attention: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if qq.dtype == torch.bfloat16 and dh != 256:
        # the tensor-core design copies rows with 16-byte cp.async
        for name, t in (("qq", qq), ("kc", kc), ("kq", kq), ("vc", vc),
                        ("vq", vq)):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(f"query_block_attention: {name} needs "
                                 f"16-byte aligned rows (strides "
                                 f"{t.stride()})")
    if f < 1 or b * h > 65535:
        raise ValueError(f"query_block_attention: needs F >= 1 and "
                         f"B*H <= 65535, got F={f}, B*H={b * h}")


def query_block_attention(qq, kc, kq, vc, vq):
    """softmax over [context keys ‖ self] per query row, fused.

    Shapes as ``query_block_attention_plain``. Inputs may be strided views
    (e.g. of the packed q/k/v projection, or batch-broadcast) as long as
    their last dim is contiguous; the kernel reads them through their
    strides. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise (also for inputs that require grad while grad mode is
    on: the kernel has no backward)."""
    if qq.device.type == "cpu":
        return query_block_attention_plain(qq, kc, kq, vc, vq)
    if qq.device.type != "cuda":
        raise ValueError(f"query_block_attention: no kernel for device "
                         f"{qq.device}")
    _check(qq, kc, kq, vc, vq)
    _build.refuse_grad("query_block_attention", qq, kc, kq, vc, vq)
    b, h, nq, dh = qq.shape
    out = torch.empty((b, h, nq, dh), dtype=qq.dtype, device=qq.device)
    tensors = (qq, kc, kq, vc, vq)
    strides = (ctypes.c_longlong * 15)(
        *[s for t in tensors for s in t.stride()[:3]])
    fn = _build.launcher("tim_query_block_attention", _ARGTYPES)
    status = fn(*[t.data_ptr() for t in tensors], out.data_ptr(), strides,
                b, h, nq, kc.shape[2], dh, int(qq.dtype == torch.bfloat16),
                1.0 / math.sqrt(dh),
                torch.cuda.current_stream(qq.device).cuda_stream)
    _build.check(status, "query_block_attention")
    query_block_attention.launches += 1
    return out


# Number of kernel launches; the plain CPU version does not count.
query_block_attention.launches = 0
