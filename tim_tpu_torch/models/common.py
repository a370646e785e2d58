"""Shared building blocks: counterpart of ``tim_tpu/models/common.py``.

Parameters stay fp32; every layer casts its input, weight and bias to the
compute dtype and the GEMM accumulates in fp32 and adds the bias before
its one rounding to the output (``common.py:75-79`` adds an fp32 bias; in
bf16 the bias here is rounded to bf16 first, in fp32 the casts are
exact).

Random init draws from an explicit ``torch.Generator`` with torch's
default distributions; released checkpoints load over it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tim_tpu_torch.ops.fused_post_attention import layer_norm_fp32
from tim_tpu_torch.ops.int8_matmul_fused import int8_matmul_fused
from tim_tpu_torch.ops.quant import int8_matmul, int8_matmul_static

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in "
                         f"{sorted(_DTYPES)}") from None


def exact_gelu(x):
    """erf-form GELU (torch's default; JAX's default is the tanh form)."""
    return F.gelu(x, approximate="none")


def linear(x, weight, bias, dtype: torch.dtype):
    """x . weight^T + bias with the casts above; weight is [out, in]."""
    return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Module):
    """nn.Linear-layout ``weight`` [out, in] and ``bias`` [out] (fp32),
    torch's default init U(+-1/sqrt(in)) unless ``bias_value`` fixes the
    bias; applied with ``linear``'s casts."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, generator: torch.Generator,
                 bias_value: float | None = None):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_features, in_features), bound, generator))
        bias = torch.empty(out_features)
        if bias_value is None:
            uniform_(bias, bound, generator)
        else:
            bias.fill_(bias_value)
        self.bias = nn.Parameter(bias)

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.dtype)


class Int8Dense(nn.Module):
    """Linear for int8 serving: counterpart of ``tim_tpu/models/common.py::
    Int8Dense``. ``weight_q`` int8 [out, in] and ``weight_scale`` fp32
    [out] (per output channel, from ``ops.quant.quantize_state_dict``),
    ``bias`` fp32; the output in the compute dtype.

    Activation quantization:
    - ``act_scale`` None: dynamic per-row abs-max scales;
    - ``act_scale`` a float: one calibrated static scale. With
      ``pallas_fused`` (the class heads under ``quant_pallas_heads``) the
      layer is ``int8_matmul_fused``: kernel 3 on a CUDA tensor, its plain
      version on the CPU; without it, ``int8_matmul_static``.
    Between ``start_calibration`` and ``stop_calibration`` the layer keeps
    the running max of |input| in ``act_absmax`` (None until an input
    arrives)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, pallas_fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.pallas_fused = pallas_fused
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.act_scale: float | None = None
        self.act_absmax: torch.Tensor | None = None
        self._calibrating = False

    def start_calibration(self) -> None:
        self._calibrating = True
        self.act_absmax = None

    def stop_calibration(self) -> None:
        self._calibrating = False

    def forward(self, x):
        if self._calibrating:
            m = x.abs().amax().float()
            self.act_absmax = (m if self.act_absmax is None
                               else torch.maximum(self.act_absmax, m))
        if self.act_scale is None:
            y = int8_matmul(x, self.weight_q, self.weight_scale)
        elif self.pallas_fused:
            return int8_matmul_fused(x, self.weight_q, self.weight_scale,
                                     self.act_scale, self.bias,
                                     out_dtype=self.dtype)
        else:
            y = int8_matmul_static(x, self.weight_q, self.weight_scale,
                                   self.act_scale)
        return (y + self.bias.float()).to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters, flax semantics: fp32 statistics with the
    fast variance, eps 1e-5, fp32 output (callers cast)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return layer_norm_fp32(x, self.weight, self.bias, self.eps)


def MLP(dims, *, dtype: torch.dtype, generator: torch.Generator,
        final: nn.Module | None = None) -> nn.Sequential:
    """Linear(dims[0]->dims[1]) -> ReLU -> ... -> Linear(->dims[-1]) [->
    final]: linears at the even indices, as the reference's Sequentials."""
    layers = []
    for i in range(len(dims) - 1):
        if i:
            layers.append(nn.ReLU())
        layers.append(TorchLinear(dims[i], dims[i + 1], dtype=dtype,
                                  generator=generator))
    if final is not None:
        layers.append(final)
    return nn.Sequential(*layers)
