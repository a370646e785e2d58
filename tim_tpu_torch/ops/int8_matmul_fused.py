"""Fused static-scale int8 matmul: counterpart of ``tim_tpu/ops/pallas_int8.py``.

    xq = clip(round_half_even(x * (1/s_x)), -127, 127)      (int8)
    y  = f32(xq . w_q^T) * (s_x * w_scale[n])  [+ bias[n]]  [-> exact GELU]

cast to ``out_dtype``. ``1/s_x`` is taken in double and rounded to float32,
``s_x * w_scale`` is a float32 product, the int8 products sum exactly in
int32: the rounding points of the TPU kernel body, which multiplies by the
reciprocal where ``ops.quant.int8_matmul_static`` divides by s_x (the two
can round a value near .5 to neighbouring integers).

``int8_matmul_fused`` launches the CUDA kernel (``csrc/int8_matmul_fused.cu``:
wgmma s8 products against a tile of quantized rows kept in shared memory)
for CUDA tensors and runs ``int8_matmul_fused_plain`` for CPU tensors.
Weights come in the port's [N, K] layout (the TPU kernel's [K, N]
transposed). On the card any K runs (``launch_plan``): K past 2048 in
chunks of 2048 through the tile (one launch each, the exact int32 sums
meeting in an [M, N] scratch), and w_q's rows at a multiple of 16 bytes
(TMA's row pitch): a caller may hand w_q already zero-padded to
``padded_k(K)`` columns (``models.common.Int8Dense`` pads once when the
layer is built); an unpadded w_q at another K is padded on each call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tim_tpu_torch import _build

_IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ACTIVATIONS = (None, "gelu")
# the kernel keeps a tile of quantized rows (128 rows of up to 1024, or 64
# of up to 2048 values) in shared memory; longer K runs in chunks of this
MAX_CHUNK = 2048
# w_q's rows are read by TMA: a multiple of this many bytes
W_PITCH = 16
# tim_int8_matmul_fused(x, w_q, w_scale, bias, out, sb, sr, batches, rows,
# k, kw, n, inv_sx, sx, gelu, x_bf16, out_bf16, partial, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def _scales(act_scale: float):
    """(1/s_x, s_x) as the float32 values the TPU kernel uses."""
    sx = float(max(act_scale, 1e-12))
    return float(np.float32(1.0 / sx)), float(np.float32(sx))


def int8_matmul_fused_plain(x, w_q, w_scale, act_scale: float, bias=None,
                            activation: Optional[str] = None, *,
                            out_dtype=torch.bfloat16):
    """The body of ``pallas_int8._kernel`` in plain PyTorch. x [..., K]
    fp32/bf16, w_q [N, K] int8, w_scale [N] fp32, bias [N] fp32 or None.
    The product sums exactly in float64 (on any device)."""
    inv_sx, sx = _scales(act_scale)
    k = x.shape[-1]
    w_q = w_q[:, :k]   # a w_q padded past K holds zeros there
    x32 = x.reshape(-1, k).float()
    inv = torch.tensor(inv_sx, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x32 * inv), -127, 127)
    acc = (xq.double() @ w_q.double().t()).float()
    y = acc * (torch.tensor(sx, dtype=torch.float32, device=x.device)
               * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    if activation == "gelu":
        y = F.gelu(y, approximate="none")
    return y.to(out_dtype).reshape(*x.shape[:-1], w_q.shape[0])


def _row_view(x):
    """(batches, rows per batch, batch stride, row stride) of x [..., K]
    as the kernel walks it; raises when x is no such view."""
    if x.dim() == 2:
        return 1, x.shape[0], 0, x.stride(0)
    if x.dim() == 3:
        return x.shape[0], x.shape[1], x.stride(0), x.stride(1)
    raise ValueError(f"int8_matmul_fused: x must be 2-D or 3-D, got "
                     f"{tuple(x.shape)}")


def padded_k(k: int) -> int:
    """w_q's row length on the card: K rounded up to ``W_PITCH``."""
    return -(-k // W_PITCH) * W_PITCH


def launch_plan(k: int):
    """(launches, w_q's padded row length) for K: one launch a chunk of
    ``MAX_CHUNK`` values of K."""
    return -(-k // MAX_CHUNK), padded_k(k)


def pad_weight(w_q):
    """w_q [N, K] zero-padded to [N, padded_k(K)] (itself where K is a
    multiple of 16): the layout the card's kernel reads in place."""
    k = w_q.shape[1]
    return w_q if padded_k(k) == k else F.pad(w_q, (0, padded_k(k) - k))


def _check(x, w_q, w_scale, bias, activation, out_dtype):
    k = x.shape[-1]
    n = w_q.shape[0]
    if x.dtype not in _IN_DTYPES or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"int8_matmul_fused: x {x.dtype} / out "
                         f"{out_dtype} not in {_IN_DTYPES}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"int8_matmul_fused: activation {activation!r} "
                         f"not in {_ACTIVATIONS}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] not in (
            k, padded_k(k)):
        raise ValueError(f"int8_matmul_fused: w_q must be int8 [N, {k}] "
                         f"(or zero-padded to [N, {padded_k(k)}]), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"int8_matmul_fused: {name} has shape "
                             f"{tuple(t.shape)}, expected {(n,)}")
    for name, t in (("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_matmul_fused: {name} on {t.device}, x "
                             f"on {x.device}")
    _row_view(x)
    if k < 1:
        raise ValueError("int8_matmul_fused: K must be positive")


def int8_matmul_fused(x, w_q, w_scale, act_scale: float, bias=None,
                      activation: Optional[str] = None, *,
                      out_dtype=torch.bfloat16):
    """Fused static-scale int8 matmul; returns [..., N] in ``out_dtype``
    (contiguous). x may be a strided [B, rows, K] view (the heads' query
    slice of the encoder output): the kernel reads it through its (batch,
    row) strides, without a copy. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (also for inputs that require grad
    while grad mode is on: the kernel has no backward)."""
    if x.device.type == "cpu":
        return int8_matmul_fused_plain(x, w_q, w_scale, act_scale, bias,
                                       activation, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_fused: no kernel for device "
                         f"{x.device}")
    _check(x, w_q, w_scale, bias, activation, out_dtype)
    _build.refuse_grad("int8_matmul_fused", x, w_q, w_scale, bias)
    if x.stride(-1) != 1:
        x = x.contiguous()
    batches, rows, sb, sr = _row_view(x)
    k, n = x.shape[-1], w_q.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    inv_sx, sx = _scales(act_scale)
    chunks, kw = launch_plan(k)
    w_q = pad_weight(w_q).contiguous()
    if w_q.data_ptr() % 16:
        w_q = w_q.clone()
    partial = (torch.empty((batches * rows, n), dtype=torch.int32,
                           device=x.device) if chunks > 1 else None)
    w_scale = w_scale.float().contiguous()
    bias_ptr = None if bias is None else bias.float().contiguous()
    fn = _build.launcher("tim_int8_matmul_fused", _ARGTYPES)
    status = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                None if bias_ptr is None else bias_ptr.data_ptr(),
                out.data_ptr(), sb, sr, batches, rows, k, kw, n, inv_sx, sx,
                int(activation == "gelu"), int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                None if partial is None else partial.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "int8_matmul_fused")
    int8_matmul_fused.launches += 1
    return out


# Number of calls that launched the kernel (one launch a chunk of K); the
# plain CPU version does not count.
int8_matmul_fused.launches = 0
