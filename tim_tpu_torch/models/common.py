"""Shared building blocks: counterpart of ``tim_tpu/models/common.py``.

Parameters stay fp32; every layer casts its input and weight to the
compute dtype and the GEMM accumulates in fp32. In bf16 a linear rounds
as the JAX layer it replaces (``linear``'s ``rounding``); in fp32 the
casts are exact and both kinds are one fp32 GEMM plus bias.

Random init draws from an explicit ``torch.Generator`` with torch's
default distributions; released checkpoints load over it.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from tim_tpu_torch.ops.bias_act import bias_act, gelu_bf16
from tim_tpu_torch.ops.fused_post_attention import layer_norm_fp32
from tim_tpu_torch.ops.int8_matmul_fused import (
    int8_matmul_fused, pad_weight, padded_k)
from tim_tpu_torch.ops.quant import (
    int8_matmul, int8_matmul_static, scale_for)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in "
                         f"{sorted(_DTYPES)}") from None


class _GeluBf16(torch.autograd.Function):
    """``gelu_bf16`` forward; the backward is ``aten.gelu_backward`` on the
    kept input, as the bf16 linears' GELU takes on the card. (JAX's bf16
    backward rounds stepwise too; the bf16 training gradients are held to
    their fp32 counterparts within a tolerance, not bit for bit.)"""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type != "cuda":
            return gelu_bf16(x)
        # on the card one pass of the bias epilogue kernel, without a bias
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return bias_act(x2, None, gelu=True)[0].view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="none")


def exact_gelu(x):
    """erf-form GELU (torch's default; JAX's default is the tanh form). In
    bf16 it rounds at ``jax.nn.gelu``'s steps (``ops/bias_act.py::
    gelu_bf16``); in fp32 it is ``F.gelu``, which agrees with JAX's fp32
    form to ~1e-7."""
    if x.dtype == torch.bfloat16:
        return _GeluBf16.apply(x)
    return F.gelu(x, approximate="none")


# How a bf16 linear rounds, after the JAX layer it replaces:
# TORCH_LINEAR: tim_tpu's ``TorchLinear`` (``common.py:76-79``) and the ViT's
#   packed qkv add the fp32 bias to the fp32 accumulator and round once;
# DENSE: flax ``nn.Dense(dtype=bf16)`` rounds the product to bf16, then adds
#   the bias rounded to bf16, in bf16 (a second rounding).
TORCH_LINEAR, DENSE = "torch_linear", "dense"


class _LinearF32Bias(torch.autograd.Function):
    """TORCH_LINEAR on the card: bf16 x [M, K] and w [N, K] into an fp32
    GEMM output (``torch.mm`` with ``out_dtype``), then the bias epilogue
    kernel (``ops/bias_act.py``): bf16(y + bias), and an exact GELU after
    it with ``gelu`` (in ``jax.nn.gelu``'s bf16 steps). The gradients are
    the plain route's: through the GELU from the kept pre-activation
    (``aten.gelu_backward``, fp32 math; JAX's backward rounds stepwise,
    and the bf16 gradients are gated against fp32, not bit for bit), dx and dw from the bf16 output
    gradient, db summed in fp32 (no fp32 copy of the gradient)."""

    @staticmethod
    def forward(ctx, x, w, b, gelu):
        y = torch.mm(x, w.t(), out_dtype=torch.float32)
        out, pre = bias_act(y, b, gelu=gelu,
                            keep_pre=any(ctx.needs_input_grad))
        ctx.gelu = gelu
        ctx.save_for_backward(x, w, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, pre = ctx.saved_tensors
        if ctx.gelu:
            g = torch.ops.aten.gelu_backward(g, pre, approximate="none")
        need = ctx.needs_input_grad
        return (g.mm(w) if need[0] else None,
                g.t().mm(x) if need[1] else None,
                g.sum(0, dtype=torch.float32) if need[2] else None, None)


class _DenseBias(torch.autograd.Function):
    """DENSE on the card: the bf16 product y [M, N] plus the bf16 bias (and
    an exact GELU with ``gelu``) in one pass of the bias epilogue kernel;
    the gradient through the GELU from the kept pre-activation, db summed
    in fp32."""

    @staticmethod
    def forward(ctx, y, b, gelu):
        out, pre = bias_act(y, b, gelu=gelu,
                            keep_pre=any(ctx.needs_input_grad))
        ctx.gelu = gelu
        ctx.save_for_backward(pre)
        return out

    @staticmethod
    def backward(ctx, g):
        pre, = ctx.saved_tensors
        if ctx.gelu:
            g = torch.ops.aten.gelu_backward(g, pre, approximate="none")
        need = ctx.needs_input_grad
        return (g if need[0] else None,
                g.sum(0, dtype=torch.float32) if need[1] else None, None)


def linear(x, weight, bias, dtype: torch.dtype, *, rounding: str,
           gelu: bool = False):
    """x . weight^T + bias in ``dtype``, then an exact GELU with ``gelu``;
    weight is [out, in]; bias may be None. ``rounding`` (TORCH_LINEAR or
    DENSE) names the JAX layer's rounding, which matters only in bf16 with
    a bias: TORCH_LINEAR is round(fp32 sum + fp32 bias) (on the CPU
    through fp32 operands, exact for bf16 inputs), DENSE is
    round(round(x . weight^T) + round(bias)). On the card the bias add
    (and the GELU) after the GEMM is one pass of the bias epilogue
    kernel."""
    if rounding not in (TORCH_LINEAR, DENSE):
        raise ValueError(f"rounding {rounding!r} not in "
                         f"{(TORCH_LINEAR, DENSE)}")
    x, w = x.to(dtype), weight.to(dtype)
    if bias is None or dtype == torch.float32:
        y = F.linear(x, w, None if bias is None else bias.to(dtype))
        return exact_gelu(y) if gelu else y
    if x.device.type == "cuda":
        x2 = x.reshape(-1, x.shape[-1])
        if rounding == TORCH_LINEAR:
            y = _LinearF32Bias.apply(x2, w, bias.float(), gelu)
        else:
            y = _DenseBias.apply(F.linear(x2, w), bias.float(), gelu)
        return y.view(*x.shape[:-1], w.shape[0])
    if rounding == DENSE:
        y = F.linear(x, w) + bias.to(dtype)
    else:
        y = (F.linear(x.float(), w.float()) + bias.float()).to(dtype)
    return exact_gelu(y) if gelu else y


class _ProductF32(torch.autograd.Function):
    """bf16 x [M, K] . w [N, K]^T into an fp32 output on the card
    (``torch.mm`` with ``out_dtype``); dx and dw from the output gradient
    in bf16, as ``_LinearF32Bias`` takes them (the gradient of a bf16
    output, so the cast is exact)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        need = ctx.needs_input_grad
        return (g.mm(w) if need[0] else None,
                g.t().mm(x) if need[1] else None)


def row_parallel_linear(x, weight, bias, dtype: torch.dtype, *,
                        rounding: str, reduce):
    """A linear whose input columns are split over the model ranks: this
    rank's partial product x . weight^T in fp32 (operands in ``dtype``),
    ``reduce`` (the sum over the ranks: ``Mesh.reduce_from_model`` or
    ``scatter_tokens``), then the bias added once and rounded once as
    ``linear``'s ``rounding`` does it after one fp32 sum."""
    if rounding not in (TORCH_LINEAR, DENSE):
        raise ValueError(f"rounding {rounding!r} not in "
                         f"{(TORCH_LINEAR, DENSE)}")
    x, w = x.to(dtype), weight.to(dtype)
    if dtype != torch.float32 and x.device.type == "cuda":
        y = _ProductF32.apply(x.reshape(-1, x.shape[-1]), w).view(
            *x.shape[:-1], w.shape[0])
    else:
        y = F.linear(x.float(), w.float())
    y = reduce(y)
    if dtype == torch.float32:
        return y if bias is None else y + bias
    if bias is None:
        return y.to(dtype)
    if rounding == DENSE:
        return y.to(dtype) + bias.to(dtype)
    return (y + bias.float()).to(dtype)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Module):
    """nn.Linear-layout ``weight`` [out, in] and ``bias`` [out] (fp32),
    torch's default init U(+-1/sqrt(in)) unless ``bias_value`` fixes the
    bias, or no bias with ``use_bias=False``; applied by ``linear`` with
    the ``rounding`` of the JAX layer it replaces."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, generator: torch.Generator,
                 rounding: str, bias_value: float | None = None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.rounding = rounding
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

    def forward(self, x, gelu: bool = False, reduce=None):
        """``reduce``: the layer is row-parallel, this rank holding a slice
        of its input columns (``row_parallel_linear``)."""
        if reduce is not None:
            return row_parallel_linear(x, self.weight, self.bias, self.dtype,
                                       rounding=self.rounding, reduce=reduce)
        return linear(x, self.weight, self.bias, self.dtype,
                      rounding=self.rounding, gelu=gelu)


class Int8Dense(nn.Module):
    """Linear for int8 serving: counterpart of ``tim_tpu/models/common.py::
    Int8Dense``. ``weight_q`` int8 [out, in] and ``weight_scale`` fp32
    [out] (per output channel, from ``ops.quant.quantize_state_dict`` or
    ``quantize_backbone_state_dict``), ``bias`` fp32 (none with
    ``use_bias=False``); the output in the compute dtype.

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
                 dtype: torch.dtype, pallas_fused: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.pallas_fused = pallas_fused
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.register_parameter("bias", None)
        self.act_scale: float | None = None
        self.act_absmax: torch.Tensor | None = None
        self._calibrating = False
        self._w_kernel = None       # kernel 3's padded weight_q, and
        self._w_kernel_key = None   # the weight it was made from

    def start_calibration(self) -> None:
        self._calibrating = True
        self.act_absmax = None

    def stop_calibration(self) -> None:
        self._calibrating = False

    def kernel_weight(self):
        """weight_q as kernel 3 reads it on the card: its rows zero-padded
        to a multiple of 16 bytes (``padded_k``), made once and again only
        after weight_q changes (a load, ``.to()``); weight_q itself where
        K is a multiple of 16 or the layer is on the CPU."""
        w = self.weight_q
        if w.device.type != "cuda" or padded_k(w.shape[1]) == w.shape[1]:
            return w
        key = (w.data_ptr(), w._version, w.shape)
        if self._w_kernel_key != key:
            self._w_kernel, self._w_kernel_key = pad_weight(w), key
        return self._w_kernel

    def forward(self, x):
        if self._calibrating:
            m = x.abs().amax().float()
            self.act_absmax = (m if self.act_absmax is None
                               else torch.maximum(self.act_absmax, m))
        if self.act_scale is None:
            y = int8_matmul(x, self.weight_q, self.weight_scale)
        elif self.pallas_fused:
            return int8_matmul_fused(x, self.kernel_weight(),
                                     self.weight_scale,
                                     self.act_scale, self.bias,
                                     out_dtype=self.dtype)
        else:
            y = int8_matmul_static(x, self.weight_q, self.weight_scale,
                                   self.act_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


def set_act_scales(layers: Mapping[str, Int8Dense], act_scales) -> None:
    """Give each int8 layer its scale from the (path, scale) tuple
    ``act_scales`` (``ops.quant.scale_for``: a layer the tuple misses
    keeps dynamic per-row scales, with a warning when the tuple is not
    empty); ``layers`` maps each layer's path to it."""
    for path, layer in layers.items():
        s = scale_for(act_scales, path)
        layer.act_scale = s if s > 0.0 else None


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
    backbones' ``mlp``: flax ``nn.Dense`` layers in JAX)."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden, dtype=dtype, generator=generator,
                               rounding=DENSE)
        self.fc2 = TorchLinear(hidden, dim, dtype=dtype, generator=generator,
                               rounding=DENSE)

    def forward(self, x):
        return self.fc2(self.fc1(x, gelu=True))


class Int8GeluMlp(nn.Module):
    """``GeluMlp`` for int8 serving: ``fc1`` and ``fc2`` are ``Int8Dense``
    (output in the compute dtype after the fp32 bias), the exact GELU
    between them in the compute dtype."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Int8Dense(dim, hidden, dtype=dtype)
        self.fc2 = Int8Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(exact_gelu(self.fc1(x)))


def MLP(dims, *, dtype: torch.dtype, generator: torch.Generator,
        final: nn.Module | None = None) -> nn.Sequential:
    """Linear(dims[0]->dims[1]) -> ReLU -> ... -> Linear(->dims[-1]) [->
    final]: linears at the even indices, as the reference's Sequentials
    (JAX's ``MLP`` of ``TorchLinear`` layers)."""
    layers = []
    for i in range(len(dims) - 1):
        if i:
            layers.append(nn.ReLU())
        layers.append(TorchLinear(dims[i], dims[i + 1], dtype=dtype,
                                  generator=generator,
                                  rounding=TORCH_LINEAR))
    if final is not None:
        layers.append(final)
    return nn.Sequential(*layers)


def inference_unless_training(forward):
    """Decorate a backbone's ``forward``: it runs under
    ``torch.inference_mode`` unless the module is in training mode with
    grad enabled, when it records autograd. Backbones are built in eval
    mode (feature extraction); ``.train()`` makes them trainable."""

    @functools.wraps(forward)
    def wrapped(self, *args, **kwargs):
        if self.training and torch.is_grad_enabled():
            return forward(self, *args, **kwargs)
        with torch.inference_mode():
            return forward(self, *args, **kwargs)

    return wrapped


def no_tf32():
    """cuDNN with TF32 off (it is on by default for convolutions), the
    other flags as they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _PatchConv(torch.autograd.Function):
    """A stride = kernel conv3d whose forward and backward both run with
    TF32 off, so that an fp32 weight gradient stays fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        stride = tuple(weight.shape[2:])
        with no_tf32():
            y = F.conv3d(x, weight, bias, stride=stride)
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride = tuple(weight.shape[2:])
        gx = gw = gb = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv3d_input(x.shape, weight, gy,
                                                stride=stride)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv3d_weight(x, weight.shape, gy,
                                                 stride=stride)
        if ctx.needs_input_grad[2]:
            gb = gy.sum((0, 2, 3, 4))
        return gx, gw, gb


def conv3d_patch_embed(video, weight, bias, dtype: torch.dtype):
    """flax ``nn.Conv(padding="VALID", strides=kernel)`` as a patch embed:
    channels-last video [B, T, H, W, C_in] -> [B, T', H', W', C_out], the
    input, kernel and bias cast to the compute dtype (flax's casts).
    ``weight`` is torch's [C_out, C_in, kt, kh, kw]. fp32 stays fp32:
    cuDNN's TF32, on by default for convolutions, is turned off here, in
    the forward and the backward."""
    x = video.to(dtype).permute(0, 4, 1, 2, 3)
    y = _PatchConv.apply(x, weight.to(dtype), bias.to(dtype))
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
