"""Post-attention encoder tail: counterpart of ``tim_tpu/ops/pallas_fused.py``.

    y = LN1(x + attn);  z = LN2(y + W2 . gelu(W1 . y + b1) + b2)

LayerNorm in fp32 with the fast variance (E[x^2] - mu^2, clamped at 0) and
eps 1e-5; both products accumulate in fp32 and add their bias in fp32;
GELU is the exact erf form; adds and intermediates round to the input
dtype where the TPU kernel rounds them.

``fused_post_attention`` launches the CUDA kernels
(``csrc/fused_post_attention.cu``) for CUDA tensors and runs
``fused_post_attention_plain`` for CPU tensors. Weights come in
``nn.Linear``'s [out, in] layout (w1 [FF, C], w2 [C, FF]); the TPU
kernel's flax layout is their transpose.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tim_tpu_torch import _build

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = 128   # C and FF must be multiples of the kernel's output tile
_MAX_BF16_C = 2048
EPS = 1e-5
# tim_fused_post_attention(10 inputs, y, h, out, n, c, ff, bf16, eps,
# stream)
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def layer_norm_fp32(x, weight, bias, eps: float = EPS):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the fast
    variance E[x^2] - mu^2 clamped at 0. Returns fp32."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def _matmul_bias(x, w, b):
    """x . w^T + b: operands rounded to x's dtype, products summed in fp32,
    bias added in fp32, one cast back to x's dtype (the kernel's rounding
    points; a bf16 library GEMM would round its sum once more)."""
    dt = x.dtype
    y = torch.matmul(x.float(), w.to(dt).float().t())
    return (y + b.float()).to(dt)


def fused_post_attention_plain(x, attn, ln1_weight, ln1_bias, w1, b1, w2, b2,
                               ln2_weight, ln2_bias):
    """The op sequence of ``_fused_kernel`` in plain PyTorch (its products
    run in fp32 whatever the dtype, so in bf16 this is the reference, not
    the fast path)."""
    dt = x.dtype
    y = layer_norm_fp32(x + attn, ln1_weight, ln1_bias).to(dt)
    h = F.gelu(_matmul_bias(y, w1, b1).float(), approximate="none").to(dt)
    o = _matmul_bias(h, w2, b2)
    return layer_norm_fp32(y + o, ln2_weight, ln2_bias).to(dt)


def _check(x, attn, ln1_weight, ln1_bias, w1, b1, w2, b2, ln2_weight,
           ln2_bias):
    c = x.shape[-1]
    ff = w1.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_post_attention: dtype {x.dtype} not in "
                         f"{_DTYPES}")
    if attn.shape != x.shape or attn.dtype != x.dtype:
        raise ValueError(f"fused_post_attention: attn {attn.dtype} "
                         f"{tuple(attn.shape)} != x {x.dtype} "
                         f"{tuple(x.shape)}")
    if tuple(w1.shape) != (ff, c) or tuple(w2.shape) != (c, ff):
        raise ValueError(f"fused_post_attention: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not fit C={c}")
    if c % _TILE or ff % _TILE:
        raise ValueError(f"fused_post_attention: C={c} and FF={ff} must be "
                         f"multiples of {_TILE}")
    if x.dtype == torch.bfloat16 and c > _MAX_BF16_C:
        raise ValueError(f"fused_post_attention: bf16 rows of at most "
                         f"{_MAX_BF16_C} channels (its LayerNorm passes keep "
                         f"a row in registers), got C={c}")
    for name, t, n in (("ln1_weight", ln1_weight, c), ("ln1_bias", ln1_bias, c),
                       ("b1", b1, ff), ("b2", b2, c),
                       ("ln2_weight", ln2_weight, c), ("ln2_bias", ln2_bias, c)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"fused_post_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(n,)}")
    for name, t in (("attn", attn), ("w1", w1), ("w2", w2), ("b1", b1),
                    ("b2", b2), ("ln1_weight", ln1_weight),
                    ("ln1_bias", ln1_bias), ("ln2_weight", ln2_weight),
                    ("ln2_bias", ln2_bias)):
        if t.device != x.device:
            raise ValueError(f"fused_post_attention: {name} on {t.device}, "
                             f"x on {x.device}")


def fused_post_attention(x, attn, ln1_weight, ln1_bias, w1, b1, w2, b2,
                         ln2_weight, ln2_bias):
    """LN2(y + FFN(y)) with y = LN1(x + attn). x/attn: [..., C] in the
    compute dtype; w1 [FF, C], w2 [C, FF] (cast to x's dtype); biases and
    LN params fp32. CPU tensors take the plain version; CUDA tensors launch
    the kernels or raise."""
    if x.device.type == "cpu":
        return fused_post_attention_plain(x, attn, ln1_weight, ln1_bias, w1,
                                          b1, w2, b2, ln2_weight, ln2_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_post_attention: no kernel for device "
                         f"{x.device}")
    _check(x, attn, ln1_weight, ln1_bias, w1, b1, w2, b2, ln2_weight,
           ln2_bias)
    dt = x.dtype
    c = x.shape[-1]
    ff = w1.shape[0]
    n = x.numel() // c
    # kernel argument order; every tensor contiguous, weights in dt,
    # biases and LN params fp32 (the kernel reads them as raw pointers)
    inputs = [x.contiguous(), attn.contiguous(),
              ln1_weight.float().contiguous(), ln1_bias.float().contiguous(),
              w1.to(dt).contiguous(), b1.float().contiguous(),
              w2.to(dt).contiguous(), b2.float().contiguous(),
              ln2_weight.float().contiguous(), ln2_bias.float().contiguous()]
    y = torch.empty((n, c), dtype=dt, device=x.device)      # scratch
    h = torch.empty((n, ff), dtype=dt, device=x.device)     # scratch
    out = torch.empty(x.shape, dtype=dt, device=x.device)
    fn = _build.launcher("tim_fused_post_attention", _ARGTYPES)
    status = fn(*[t.data_ptr() for t in inputs + [y, h, out]],
                n, c, ff, int(dt == torch.bfloat16), EPS,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "fused_post_attention")
    fused_post_attention.launches += 1
    return out


# Number of calls that launched the kernels (bf16: four launches each, the
# LN1 pass, the two products, the LN2 pass; fp32: two); the plain CPU
# version does not count.
fused_post_attention.launches = 0
