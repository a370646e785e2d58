"""The bias epilogue of the bf16 linears (``csrc/bias_act.cu``).

A bf16 linear rounds as the JAX layer it replaces (``models/common.py``):
tim_tpu's ``TorchLinear`` adds the fp32 bias to the GEMM's fp32 output and
rounds once; flax ``nn.Dense`` rounds the product, then adds the bias
rounded to bf16, in bf16. ``bias_act`` is that add, with an optional exact
(erf) GELU after it, as one pass:

- ``y`` fp32 (the TorchLinear kind): ``h = bf16(y + bias)``;
- ``y`` bf16 (the nn.Dense kind): ``h = bf16(y + bf16(bias))``;
- ``bias`` None: ``h = bf16(y)`` (the exact GELU alone);
- ``gelu``: ``gelu_bf16(h)``, the exact GELU in ``jax.nn.gelu``'s bf16
  steps, else ``h``.

CUDA tensors launch the kernel or raise; CPU tensors take
``bias_act_plain``. JAX leaves this to XLA; no Pallas kernel is replaced.
"""

from __future__ import annotations

import ctypes

import torch

from tim_tpu_torch import _build

# tim_bias_act(y, y_f32, bias, out, pre, rows, cols, gelu, stream)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


# sqrt(1/2) rounded to bf16, the constant jax.nn.gelu multiplies by in bf16
SQRT_HALF_BF16 = 0.70703125


def gelu_bf16(h):
    """``jax.nn.gelu(h, approximate=False)`` for a bf16 ``h``, as XLA runs
    it: every step a bf16 operation, rounded,
    ``bf16(bf16(0.5 h) * bf16(erfc(bf16(-h * 0.70703125))))``. Each step
    is computed in fp32 and rounded once (a product of two bf16 values is
    exact in fp32). One fp32 GELU rounded once differs from it in about
    40% of the outputs. (The fused tail's GELU, kernel 2, and the int8
    heads', kernel 3, are fp32 in JAX too, and stay so.)"""
    bf = torch.bfloat16
    half = (h.float() * 0.5).to(bf)
    d = (h.float() * -SQRT_HALF_BF16).to(bf)
    e = torch.special.erfc(d.float()).to(bf)
    return (half.float() * e.float()).to(bf)


def bias_act_plain(y, bias, *, gelu: bool):
    """The kernel's function in plain PyTorch: (out, h)."""
    if bias is None:
        h = y.to(torch.bfloat16)
    elif y.dtype == torch.float32:
        h = (y + bias.float()).to(torch.bfloat16)
    else:
        h = y + bias.to(torch.bfloat16)
    return (gelu_bf16(h) if gelu else h), h


def _check(y, bias):
    if y.dtype not in (torch.float32, torch.bfloat16) or y.dim() != 2:
        raise ValueError(f"bias_act: y must be fp32 or bf16 [rows, cols], "
                         f"got {y.dtype} {tuple(y.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (y.shape[1],)
                             or bias.device != y.device):
        raise ValueError(f"bias_act: bias must be fp32 [{y.shape[1]}] on "
                         f"{y.device}, got {bias.dtype} {tuple(bias.shape)}")
    if not y.is_contiguous() or not (bias is None or bias.is_contiguous()):
        raise ValueError("bias_act: y and bias must be contiguous")


def bias_act(y, bias, *, gelu: bool, keep_pre: bool = False):
    """(out, h or None) of ``bias_act_plain`` for a 2-d ``y``; ``h`` (the
    bf16 pre-activation) is returned on the card only with ``keep_pre``
    (and ``gelu``), for a backward."""
    if y.device.type == "cpu":
        out, h = bias_act_plain(y, bias, gelu=gelu)
        return out, (h if keep_pre and gelu else None)
    if y.device.type != "cuda":
        raise ValueError(f"bias_act: no kernel for device {y.device}")
    _check(y, bias)
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    pre = torch.empty_like(out) if keep_pre and gelu else None
    fn = _build.launcher("tim_bias_act", _ARGTYPES)
    status = fn(y.data_ptr(), int(y.dtype == torch.float32),
                None if bias is None else bias.data_ptr(),
                out.data_ptr(), None if pre is None else pre.data_ptr(),
                y.shape[0], y.shape[1], int(gelu),
                torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(status, "bias_act")
    bias_act.launches += 1
    return out, pre


# Number of kernel launches; the plain CPU version does not count.
bias_act.launches = 0
