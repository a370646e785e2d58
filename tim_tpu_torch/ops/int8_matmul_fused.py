"""Fused static-scale int8 matmul: counterpart of ``tim_tpu/ops/pallas_int8.py``.

    xq = clip(round_half_even(x * (1/s_x)), -127, 127)      (int8)
    y  = f32(xq . w_q^T) * (s_x * w_scale[n])  [+ bias[n]]  [-> exact GELU]

cast to ``out_dtype``. ``1/s_x`` is taken in double and rounded to float32,
``s_x * w_scale`` is a float32 product, the int8 products sum exactly in
int32: the rounding points of the TPU kernel body, which multiplies by the
reciprocal where ``ops.quant.int8_matmul_static`` divides by s_x (the two
can round a value near .5 to neighbouring integers).

``int8_matmul_fused`` launches the CUDA kernel (``csrc/int8_matmul_fused.cu``:
wgmma s8 products against a tile of quantized rows kept in shared memory,
so K is at most 2048) for CUDA tensors and runs ``int8_matmul_fused_plain``
for CPU tensors. Weights come in the port's [N, K] layout (the TPU
kernel's [K, N] transposed).
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
_ALIGN = 8     # x's row strides, in elements, must be multiples of this
# the kernel keeps a tile of quantized rows (128 rows of up to 1024, or 64
# of up to 2048 values) in shared memory
_MAX_K = 2048
# tim_int8_matmul_fused(x, w_q, w_scale, bias, out, sb, sr, batches, rows,
# k, n, inv_sx, sx, gelu, x_bf16, out_bf16, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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


def _check(x, w_q, w_scale, bias, activation, out_dtype):
    k = x.shape[-1]
    n = w_q.shape[0]
    if x.dtype not in _IN_DTYPES or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"int8_matmul_fused: x {x.dtype} / out "
                         f"{out_dtype} not in {_IN_DTYPES}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"int8_matmul_fused: activation {activation!r} "
                         f"not in {_ACTIVATIONS}")
    if w_q.dtype != torch.int8 or tuple(w_q.shape) != (n, k):
        raise ValueError(f"int8_matmul_fused: w_q must be int8 [N, {k}], "
                         f"got {w_q.dtype} {tuple(w_q.shape)}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"int8_matmul_fused: {name} has shape "
                             f"{tuple(t.shape)}, expected {(n,)}")
    for name, t in (("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_matmul_fused: {name} on {t.device}, x "
                             f"on {x.device}")
    _, _, sb, sr = _row_view(x)
    if (x.stride(-1) != 1 or k % 16 or k > _MAX_K or sb % _ALIGN
            or sr % _ALIGN or x.data_ptr() % 16):
        raise ValueError(
            f"int8_matmul_fused: x needs a contiguous last dim, K a "
            f"multiple of 16 up to {_MAX_K}, row strides that are multiples "
            f"of {_ALIGN} and a 16-byte aligned start (K={k}, strides "
            f"{x.stride()})")


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
    batches, rows, sb, sr = _row_view(x)
    k, n = x.shape[-1], w_q.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    inv_sx, sx = _scales(act_scale)
    w_q = w_q.contiguous()
    if w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_fused: w_q must start 16-byte aligned")
    w_scale = w_scale.float().contiguous()
    bias_ptr = None if bias is None else bias.float().contiguous()
    fn = _build.launcher("tim_int8_matmul_fused", _ARGTYPES)
    status = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                None if bias_ptr is None else bias_ptr.data_ptr(),
                out.data_ptr(), sb, sr, batches, rows, k, n, inv_sx, sx,
                int(activation == "gelu"), int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "int8_matmul_fused")
    int8_matmul_fused.launches += 1
    return out


# Number of kernel launches; the plain CPU version does not count.
int8_matmul_fused.launches = 0
