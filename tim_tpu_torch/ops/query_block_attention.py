"""TIM query-block attention: counterpart of ``tim_tpu/ops/pallas_attention.py``.

Each interval-query token attends to the F context keys plus exactly one
more key, its own: a softmax over F+1 scores scaled by 1/sqrt(dh), then the
weighted sum of the context values and its own value. Internals are fp32,
the output is in the input dtype.

``query_block_attention`` launches the CUDA kernel
(``csrc/query_block_attention.cu``) for CUDA tensors and runs
``query_block_attention_plain``, the same function in plain PyTorch, for
CPU tensors. There is no fallback between the two. On the card it takes
any head dim from 1 to 256 and any row strides (``launch_plan``): bf16
rows that are 16-byte aligned at head dims 32, 64, 128 and 160 take the
tensor-core design in place; other bf16 inputs up to head dim 160 are
copied once into zero-padded rows of the next of those head dims
(``copy_width``; zero columns add nothing to the scores, the scale stays
1/sqrt(dh), the output's padding is sliced off); fp32, and bf16 past 160,
take the CUDA-core design (its lanes' dims past dh masked where dh is not
32, 64, 128 or 256).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tim_tpu_torch import _build
from tim_tpu_torch.ops.flash_mha import aligned

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
# head dims of the bf16 tensor-core instances
TENSOR_CORE_HEAD_DIMS = (32, 64, 128, 160)
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
# tim_query_block_attention(qq, kc, kq, vc, vq, out, strides, b, h, nq, f,
# dh, bf16, cuda_cores, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])


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
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"query_block_attention: head dim {dh} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if f < 1 or b * h > 65535:
        raise ValueError(f"query_block_attention: needs F >= 1 and "
                         f"B*H <= 65535, got F={f}, B*H={b * h}")


def launch_plan(dh: int, dtype, *tensors) -> str:
    """The kernel design that runs these inputs: ``TENSOR_CORES`` for bf16
    at a tensor-core head dim with every row 16-byte aligned, else
    ``CUDA_CORES`` (fp32 always; bf16 at any other head dim, or with rows
    that the tensor-core design's 16-byte cp.async copies cannot read,
    ``flash_mha.aligned``)."""
    if (dtype == torch.bfloat16 and dh in TENSOR_CORE_HEAD_DIMS
            and all(aligned(t) for t in tensors)):
        return TENSOR_CORES
    return CUDA_CORES


def copy_width(dh: int, dtype, *tensors):
    """The head dim of the zero-padded copy that takes bf16 inputs the
    tensor-core design cannot read in place onto it (the least tensor-core
    head dim >= dh), or None: no copy (fp32, in-place tensor cores, or dh
    past 160, which the CUDA-core design takes)."""
    if (dtype != torch.bfloat16
            or launch_plan(dh, dtype, *tensors) == TENSOR_CORES
            or dh > TENSOR_CORE_HEAD_DIMS[-1]):
        return None
    return min(w for w in TENSOR_CORE_HEAD_DIMS if w >= dh)


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
    tensors = (qq, kc, kq, vc, vq)
    width = copy_width(dh, qq.dtype, *tensors)
    if width is not None:
        out = _launch([torch.nn.functional.pad(t, (0, width - dh))
                       for t in tensors], 1.0 / math.sqrt(dh))
        return out[..., :dh]
    return _launch(tensors, 1.0 / math.sqrt(dh))


def _launch(tensors, scale: float):
    """One launch on ``tensors`` (qq, kc, kq, vc, vq) at their head dim,
    scores scaled by ``scale``; returns the contiguous output."""
    qq, kc = tensors[0], tensors[1]
    b, h, nq, dh = qq.shape
    out = torch.empty((b, h, nq, dh), dtype=qq.dtype, device=qq.device)
    strides = (ctypes.c_longlong * 15)(
        *[s for t in tensors for s in t.stride()[:3]])
    fn = _build.launcher("tim_query_block_attention", _ARGTYPES)
    plan = launch_plan(dh, qq.dtype, *tensors)
    status = fn(*[t.data_ptr() for t in tensors], out.data_ptr(), strides,
                b, h, nq, kc.shape[2], dh, int(qq.dtype == torch.bfloat16),
                int(plan == CUDA_CORES), scale,
                torch.cuda.current_stream(qq.device).cuda_stream)
    _build.check(status, "query_block_attention")
    query_block_attention.launches += 1
    return out


# Number of kernel launches; the plain CPU version does not count.
query_block_attention.launches = 0
