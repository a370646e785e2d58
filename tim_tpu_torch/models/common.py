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
    """x . weight^T + bias with the casts above; weight is [out, in];
    bias may be None."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Module):
    """nn.Linear-layout ``weight`` [out, in] and ``bias`` [out] (fp32),
    torch's default init U(+-1/sqrt(in)) unless ``bias_value`` fixes the
    bias, or no bias with ``use_bias=False``; applied with ``linear``'s
    casts."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, generator: torch.Generator,
                 bias_value: float | None = None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_features, in_features), bound, generator))
        if not use_bias:
            self.register_parameter("bias", None)
            return
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
    fast variance, eps 1e-5 unless given (the ViT's are 1e-6), fp32 output
    (callers cast)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return layer_norm_fp32(x, self.weight, self.bias, self.eps)


class GeluMlp(nn.Module):
    """``fc1`` -> exact GELU -> ``fc2`` in the compute dtype (the
    backbones' ``mlp``)."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden, dtype=dtype, generator=generator)
        self.fc2 = TorchLinear(hidden, dim, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.fc2(exact_gelu(self.fc1(x)))


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


def conv3d_patch_embed(video, weight, bias, dtype: torch.dtype):
    """flax ``nn.Conv(padding="VALID", strides=kernel)`` as a patch embed:
    channels-last video [B, T, H, W, C_in] -> [B, T', H', W', C_out], the
    input, kernel and bias cast to the compute dtype (flax's casts).
    ``weight`` is torch's [C_out, C_in, kt, kh, kw]. fp32 stays fp32:
    cuDNN's TF32, on by default for convolutions, is turned off here."""
    x = video.to(dtype).permute(0, 4, 1, 2, 3)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv3d(x, weight.to(dtype), bias.to(dtype),
                     stride=tuple(weight.shape[2:]))
    return y.permute(0, 2, 3, 4, 1)


class Conv3dParams(nn.Module):
    """``nn.Conv3d``'s ``weight`` [out, in, kt, kh, kw] and ``bias``
    [out] (fp32), torch's default bound U(+-1/sqrt(fan_in)) drawn from
    ``generator``."""

    def __init__(self, in_channels: int, out_channels: int, kernel, *,
                 generator: torch.Generator):
        super().__init__()
        kernel = tuple(kernel)
        bound = 1.0 / math.sqrt(in_channels * math.prod(kernel))
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_channels, in_channels, *kernel), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound,
                                          generator))


class PatchEmbed3D(nn.Module):
    """Conv3D patch embedding, stride = kernel, channels-last in and out:
    ``proj`` (the reference's ``patch_embed.proj``) and, with ``norm``,
    a LayerNorm (``patch_embed.norm``, eps 1e-5) whose fp32 output is cast
    to the compute dtype."""

    def __init__(self, patch, dim: int, *, dtype: torch.dtype,
                 generator: torch.Generator, in_channels: int = 3,
                 norm: bool = False):
        super().__init__()
        self.dtype = dtype
        self.proj = Conv3dParams(in_channels, dim, patch, generator=generator)
        self.norm = LayerNorm(dim) if norm else None

    def forward(self, video):
        x = conv3d_patch_embed(video, self.proj.weight, self.proj.bias,
                               self.dtype)
        if self.norm is not None:
            x = self.norm(x).to(self.dtype)
        return x
