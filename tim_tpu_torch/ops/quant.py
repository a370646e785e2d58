"""Int8 quantized inference: counterpart of ``tim_tpu/ops/quant.py``.

- weights: symmetric per-output-channel int8 (``quantize_kernel``, a numpy
  copy of the JAX function, so that int8 weights and scales come out
  bit-identical), converted offline from the fp32 state dict
  (``quantize_state_dict``);
- activations: dynamic per-row int8 (``int8_matmul``) or one calibrated
  per-layer scale (``int8_matmul_static``; calibration by
  ``calibrate_act_scales``).

The int8 x int8 products sum exactly: in float64 on the CPU (every partial
sum of int8 products is an integer below 2^53, where float32 would round
past 2^24, as at K = 2048), and with ``torch._int_mm`` (int32 sums) on
CUDA, where the JAX package leaves these products to XLA. The fused head
kernel is ``ops/int8_matmul_fused.py``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-12


def quantize_kernel(w) -> Tuple[np.ndarray, np.ndarray]:
    """fp kernel [in, out] -> (int8 kernel, fp32 per-out-channel scale)."""
    w = np.asarray(w, np.float32)
    scale = np.max(np.abs(w), axis=0) / 127.0
    scale = np.maximum(scale, 1e-12)
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return w_q, scale.astype(np.float32)


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact x_q . w_q^T as float32: x_q [M, K] integer-valued (any dtype),
    w_q [N, K] int8. The int32 sums, rounded once to float32 as JAX's
    ``astype(float32)`` rounds them."""
    if x_q.device.type == "cpu":
        return (x_q.double() @ w_q.double().t()).float()
    # torch._int_mm on CUDA takes M > 16 rows, and K and N multiples of 8
    # (zero columns of K add nothing)
    m, n, k = x_q.shape[0], w_q.shape[0], w_q.shape[1]
    x8 = F.pad(x_q.to(torch.int8), (0, -k % 8, 0, max(17 - m, 0)))
    w8 = F.pad(w_q, (0, -k % 8, 0, -n % 8))
    return torch._int_mm(x8, w8.t())[:m, :n].float()


def _quantize(x32: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(x / s_x), -127, 127), still float32."""
    return torch.clamp(torch.round(x32 / s_x), -127, 127)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Dynamic per-row activation int8 matmul: x [..., K] -> [..., N] fp32.
    w_q [N, K] int8, scale [N] fp32."""
    shape = x.shape
    x32 = x.reshape(-1, shape[-1]).float()
    s_x = torch.clamp_min(x32.abs().amax(-1, keepdim=True) / 127.0, EPS)
    y = int8_product(_quantize(x32, s_x), w_q) * (s_x * scale)
    return y.reshape(*shape[:-1], w_q.shape[0])


def int8_matmul_static(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       act_scale: float) -> torch.Tensor:
    """Static-activation int8 matmul with one calibrated per-layer scale:
    x is divided by it (the fused kernel multiplies by its reciprocal)."""
    shape = x.shape
    # max(act_scale, 1e-12) as the float32 scalar the JAX path computes
    s_x = torch.tensor(max(act_scale, EPS), dtype=torch.float32,
                       device=x.device)
    x32 = x.reshape(-1, shape[-1]).float()
    y = int8_product(_quantize(x32, s_x), w_q) * (s_x * scale)
    return y.reshape(*shape[:-1], w_q.shape[0])


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def act_scale_from_absmax(absmax: float) -> float:
    """Calibrated scale of one layer: abs-max / 127, at least 1e-12, as a
    float32 value (the JAX package stores it as ``jnp.float32``)."""
    return float(np.float32(max(float(absmax) / 127.0, EPS)))


def calibrate_act_scales(layers: Mapping[str, torch.nn.Module],
                         run: Callable[[object], object],
                         batches: Iterable) -> Tuple[Tuple[str, float], ...]:
    """Run ``run(batch)`` for every calibration batch while the named
    ``Int8Dense`` layers record the abs-max of their inputs, then return the
    sorted (name, scale) tuple ``ModelConfig.quant_act_scales`` takes.
    Layers that no batch reached get no scale."""
    for layer in layers.values():
        layer.start_calibration()
    try:
        for batch in batches:
            run(batch)
        absmax = {name: layer.act_absmax for name, layer in layers.items()}
    finally:
        for layer in layers.values():
            layer.stop_calibration()
    return tuple(sorted((name, act_scale_from_absmax(m.item()))
                        for name, m in absmax.items() if m is not None))


# ---------------------------------------------------------------------------
# state dict
# ---------------------------------------------------------------------------

# Encoder matmuls and class heads carry ~95% of inference FLOPs; the time
# MLP, embedders, regression heads and drloc stay in the compute dtype.
_QUANTIZED = re.compile(
    r"^((backbone|transformer_encoder)\.layers\.\d+\."
    r"(self_attn\.(in_proj|out_proj)|linear[12])|cls_head\.fc_\w+)$")


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """fp32 reference-layout TIM state dict (detection or recognition) ->
    the layout of the quantized model: every encoder and class-head
    weight [out, in] becomes ``<name>.weight_q`` int8 and
    ``<name>.weight_scale`` fp32
    (the packed q/k/v ``in_proj_weight`` under ``self_attn.in_proj``, its
    bias as ``self_attn.in_proj.bias``). Per-output-row scales, so the
    packed rows quantize exactly as the JAX package's separate q/k/v."""
    out = dict(state_dict)
    for key, w in state_dict.items():
        if key.endswith(".in_proj_weight"):
            name = key[:-len("_weight")]
            out[f"{name}.bias"] = out.pop(f"{name}_bias")
        elif key.endswith(".weight"):
            name = key[:-len(".weight")]
        else:
            continue
        if not _QUANTIZED.match(name):
            continue
        del out[key]
        w_q, scale = quantize_kernel(w.detach().cpu().numpy().T)
        out[f"{name}.weight_q"] = torch.from_numpy(np.ascontiguousarray(w_q.T))
        out[f"{name}.weight_scale"] = torch.from_numpy(scale)
    return out


# ---------------------------------------------------------------------------
# backbones (Swin3D, VideoMAE ViT)
# ---------------------------------------------------------------------------

def scale_for(act_scales, name: str, default: float = 0.0) -> float:
    """A layer's calibrated activation scale in a (path, scale) tuple
    (paths '/'-joined, the JAX package's param paths). A miss against a
    non-empty tuple is almost always a calibration or naming fault (the
    layer keeps its dynamic per-row scales): it warns, as the JAX
    package's ``scale_for`` does."""
    for path, s in act_scales:
        if path == name:
            return float(s)
    if act_scales:
        import logging
        logging.getLogger(__name__).warning(
            "scale_for: no calibrated activation scale for %r (tuple has "
            "%d entries, e.g. %r); the layer keeps dynamic per-row "
            "scales", name, len(act_scales), act_scales[0][0])
    return default


def filter_scales(act_scales, prefix: str):
    """Sub-tuple of scales under ``prefix`` with the prefix stripped."""
    pre = prefix + "/"
    return tuple((p[len(pre):], s) for p, s in act_scales
                 if p.startswith(pre))


# Backbone matmuls that carry ~99% of extraction FLOPs (Swin/ViT qkv,
# attention out-proj, FFN). Conv patch embeds, LayerNorms, the rel-pos
# table and the PatchMerging reductions stay as they are.
BACKBONE_QUANT_MODULES = ("qkv", "proj", "fc1", "fc2")


def quantize_backbone_state_dict(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """fp32 reference-layout backbone state dict (Swin3D or VideoMAE ViT)
    -> the layout of the ``quantized=True`` backbone: every 2-D weight
    [out, in] of a ``qkv`` / ``proj`` / ``fc1`` / ``fc2`` module becomes
    ``<name>.weight_q`` int8 and ``<name>.weight_scale`` fp32 [out]
    (counterpart of ``quantize_backbone_params``; the ViT's bias-free
    packed ``attn.qkv.weight`` becomes an int8 layer without bias, its
    ``q_bias`` / ``v_bias`` stay beside it). Per-output-row scales, bit-equal
    to the JAX package's per-output-channel ones."""
    out = {}
    for key, w in state_dict.items():
        name = key[:-len(".weight")] if key.endswith(".weight") else None
        if (name is None or w.ndim != 2
                or name.rsplit(".", 1)[-1] not in BACKBONE_QUANT_MODULES):
            out[key] = w
            continue
        w_q, scale = quantize_kernel(w.detach().cpu().float().numpy().T)
        out[f"{name}.weight_q"] = torch.from_numpy(np.ascontiguousarray(w_q.T))
        out[f"{name}.weight_scale"] = torch.from_numpy(scale)
    return out
