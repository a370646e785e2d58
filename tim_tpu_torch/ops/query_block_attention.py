"""TIM query-block attention: counterpart of ``tim_tpu/ops/pallas_attention.py``.

Each interval-query token attends to the F context keys plus exactly one
more key, its own: a softmax over F+1 scores scaled by 1/sqrt(dh), then the
weighted sum of the context values and its own value. Internals are fp32,
the output is in the input dtype.

``query_block_attention`` launches the CUDA kernel
(``csrc/query_block_attention.cu``) for CUDA tensors and runs
``query_block_attention_plain``, the same function in plain PyTorch, for
CPU tensors. There is no fallback between the two. On the card it takes
any head dim and any row strides (``launch_plan``, ``copy_width``): bf16
rows that are 16-byte aligned at head dims 32, 64, 128 and 160 take the
tensor-core design in place; other bf16 inputs up to head dim 160 are
copied once into zero-padded rows of the next of those head dims (zero
columns add nothing to the scores, the scale stays 1/sqrt(dh), the
output's padding is sliced off). bf16 past 160 takes the column-slice
design (``csrc/query_block_attention_cols.cu``: wgmma, 256 output columns
a block, so up to 256 one slice; in bf16 from 513 to 2048 the slices of a
query tile as one thread-block cluster, ``flash_mha.CLUSTER_DIMS``), in
place where the rows are 16-byte aligned and dh is a multiple of 8, else
through one copy zero-padded to the next multiple of 64. fp32 takes the
CUDA-core design up to 256 (its lanes' dims past dh masked where dh is not
32, 64, 128 or 256) and the column slices on the CUDA cores past it. Each
launch counts one on ``launches`` and on its route
(``routes[route(...)]``).
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from tim_tpu_torch import _build
from tim_tpu_torch.ops.flash_mha import aligned, slices_route

_DTYPES = (torch.float32, torch.bfloat16)
# head dims of the bf16 tensor-core instances; past the last, bf16 takes
# the column slices
TENSOR_CORE_HEAD_DIMS = (32, 64, 128, 160)
# the widest head dim of fp32's CUDA-core design; past it, column slices
CUDA_CORE_MAX = 256
TENSOR_CORES, CUDA_CORES, COLS = "tensor_cores", "cuda_cores", "cols"
# tim_query_block_attention(qq, kc, kq, vc, vq, out, strides, b, h, nq, f,
# dh, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
# tim_query_block_attention_cols(qq, kc, kq, vc, vq, out, strides, b, h,
# nq, f, dh, bf16, scale, stream)
_COLS_ARGTYPES = ([ctypes.c_void_p] * 6
                  + [ctypes.POINTER(ctypes.c_longlong)]
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
    if dh < 1:
        raise ValueError(f"query_block_attention: head dim {dh} < 1")
    if f < 1 or b * h > 65535:
        raise ValueError(f"query_block_attention: needs F >= 1 and "
                         f"B*H <= 65535, got F={f}, B*H={b * h}")


def launch_plan(dh: int, dtype) -> str:
    """The kernel design that runs head dim ``dh`` in ``dtype``, in place
    or on the copy that ``copy_width`` names (the copy, not the design,
    depends on the inputs' layout): bf16 ``TENSOR_CORES`` up to head dim
    160 and ``COLS`` past it; fp32 ``CUDA_CORES`` up to 256 and ``COLS``
    past it."""
    if dtype == torch.bfloat16:
        return TENSOR_CORES if dh <= TENSOR_CORE_HEAD_DIMS[-1] else COLS
    return CUDA_CORES if dh <= CUDA_CORE_MAX else COLS


def copy_width(dh: int, dtype, *tensors):
    """The head dim of the zero-padded copy that takes bf16 inputs a
    design cannot read in place onto it, or None: no copy. On the tensor
    cores the least tensor-core head dim >= dh, unless dh is one and every
    row is 16-byte aligned (``flash_mha.aligned``); on the column slices
    (TMA's boxes need 16-byte rows) the next multiple of 64 where dh is no
    multiple of 8 or a row is not 16-byte aligned. fp32 takes no copy."""
    if dtype != torch.bfloat16:
        return None
    in_place = all(aligned(t) for t in tensors)
    if launch_plan(dh, dtype) == COLS:
        return None if dh % 8 == 0 and in_place else -(-dh // 64) * 64
    if dh in TENSOR_CORE_HEAD_DIMS and in_place:
        return None
    return min(w for w in TENSOR_CORE_HEAD_DIMS if w >= dh)


def route(dh: int, dtype, plan: str, copied: bool = False) -> str:
    """The name of the route that a launch at head dim ``dh`` (the
    launched width) on ``plan`` takes, the key of its count in
    ``query_block_attention.routes``: "tensor cores 128", "fp32 cuda cores
    256", on the column slices ``flash_mha.slices_route``'s names ("wgmma
    slices 256", "wgmma cluster slices 1024", "fp32 cuda cores slices
    512"); " via copy" when the zero-padded copy was taken."""
    if plan == COLS:
        name = slices_route(dtype, dh)
    elif plan == CUDA_CORES:
        name = f"fp32 cuda cores {dh}"
    else:
        name = f"tensor cores {dh}"
    return name + (" via copy" if copied else "")


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
                       for t in tensors], 1.0 / math.sqrt(dh), True)
        return out[..., :dh]
    return _launch(tensors, 1.0 / math.sqrt(dh), False)


def _launch(tensors, scale: float, copied: bool):
    """One launch on ``tensors`` (qq, kc, kq, vc, vq) at their head dim,
    scores scaled by ``scale`` (``copied``: they are the zero-padded copy,
    for the route's count); returns the contiguous output."""
    qq, kc = tensors[0], tensors[1]
    b, h, nq, dh = qq.shape
    out = torch.empty((b, h, nq, dh), dtype=qq.dtype, device=qq.device)
    strides = (ctypes.c_longlong * 15)(
        *[s for t in tensors for s in t.stride()[:3]])
    plan = launch_plan(dh, qq.dtype)
    bf16 = int(qq.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(qq.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
    if plan == COLS:
        fn = _build.launcher("tim_query_block_attention_cols",
                             _COLS_ARGTYPES)
        status = fn(*ptrs, strides, b, h, nq, kc.shape[2], dh, bf16, scale,
                    stream)
    else:
        fn = _build.launcher("tim_query_block_attention", _ARGTYPES)
        status = fn(*ptrs, strides, b, h, nq, kc.shape[2], dh, bf16, scale,
                    stream)
    _build.check(status, "query_block_attention")
    query_block_attention.launches += 1
    query_block_attention.routes[route(dh, qq.dtype, plan, copied)] += 1
    return out


# Numbers of kernel launches, and of each by route (``route``); the plain
# CPU version does not count.
query_block_attention.launches = 0
query_block_attention.routes = collections.Counter()
