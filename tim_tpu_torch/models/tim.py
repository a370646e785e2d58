"""TIM detection model: counterpart of ``tim_tpu/models/tim.py::TimDetection``.

Parameter names follow the reference torch ``state_dict``
(``tim_tpu/convert/torch_import.py:168-191`` reads the same layout), so
released detection checkpoints load with ``load_state_dict(strict=True)``:
``time_mlp.{0,2,4,6}``, ``feature_encoding.*``, ``backbone.layers.N.*``,
``cls_head.fc_*``, ``reg_head.fc_*_action.{0,2,4}``, ``drloc_mlp.{0,2,4}``.

``encoder_forward(..., dropout_seed=None)`` is the deterministic
(inference, validation) forward; an int ``dropout_seed`` makes it the
training forward: the feature encoding's dropout draws from a device
generator seeded ``dropout_seed``, encoder layer i's from one seeded
``dropout_seed + 1 + i`` (its own, so that ``remat`` replays it).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tim_tpu_torch.config import DetectionConfig
from tim_tpu_torch.models.common import MLP, Int8Dense, LayerNorm, dtype_of
from tim_tpu_torch.models.encodings import FeatureEncoding
from tim_tpu_torch.models.heads import DetectionClsHead, DetectionRegHead
from tim_tpu_torch.models.transformer import Encoder

# Config options whose code paths are not ported yet, with the value the
# port supports.
_UNPORTED = {"apply_feature_pooling": False, "sequence_parallel": False}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and a CUDA
    device without a card raises (pass ``device="cpu"`` for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           f"torch.cuda.is_available() is false; pass "
                           f"device='cpu' to run on the CPU")
    return device


class TimDetection(nn.Module):
    """Detection variant: shared query tokens, cls + interval-regression
    heads, and the drloc MLP of the training loss.

    ``device``: the CUDA card by default (raises without one); the CPU
    only when asked for. ``generator`` seeds the random init (a fresh
    generator seeded 0 when None); parameters are built on the CPU and
    then moved to ``device``.

    ``cfg.quantized_inference``: the encoder linears and class heads are
    ``Int8Dense`` (load ``ops.quant.quantize_state_dict`` weights), with
    dynamic activation scales, or with ``quant_static_acts`` the static
    scales of ``cfg.quant_act_scales`` (a layer without one raises)."""

    def __init__(self, cfg: DetectionConfig, *,
                 device: Optional[torch.device | str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, value in _UNPORTED.items():
            if getattr(cfg, name) != value:
                raise ValueError(f"TimDetection: {name}={getattr(cfg, name)!r}"
                                 f" is not ported (supported: {value!r})")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = dt = dtype_of(cfg)
        d = cfg.d_model
        width = cfg.encoder_width
        g = generator

        # Linear(2->d) -> ReLU x3 -> LayerNorm (time_mlp.6)
        self.time_mlp = nn.Sequential(
            *MLP((2, d, d, d), dtype=dt, generator=g, final=nn.ReLU()),
            LayerNorm(d))
        self.feature_encoding = FeatureEncoding(
            d, cfg.input_modality, cfg.data_modality, cfg.num_feats,
            cfg.visual_input_dim, cfg.audio_input_dim, dtype=dt, generator=g,
            feat_dropout=cfg.feat_dropout, seq_dropout=cfg.seq_dropout)
        quantized = cfg.quantized_inference
        self.backbone = Encoder(
            width, cfg.nhead, d * cfg.feedforward_scale, cfg.num_layers,
            dtype=dt, fused=cfg.use_fused_ffn, generator=g,
            quantized=quantized, fast_scores=cfg.fast_scores,
            dropout_rate=cfg.enc_dropout, dropout_bits=cfg.dropout_bits,
            remat=cfg.remat)
        # Linear(4d->d) -> ReLU -> Linear(d->d) -> ReLU -> Linear(d->1)
        self.drloc_mlp = MLP((2 * width, d, d, 1), dtype=dt, generator=g)
        vis = (cfg.visual_classes if "visual" in cfg.data_modality
               else None)
        aud = cfg.audio_classes if "audio" in cfg.data_modality else None
        self.cls_head = DetectionClsHead(
            width, vis, aud, dtype=dt, generator=g, quantized=quantized,
            pallas_fused=cfg.quant_pallas_heads)
        self.reg_head = DetectionRegHead(width, vis is not None,
                                         aud is not None, dtype=dt,
                                         generator=g)
        if quantized and cfg.quant_static_acts:
            scales = dict(cfg.quant_act_scales)
            for name, layer in self.int8_layers().items():
                if name not in scales:
                    raise ValueError(f"TimDetection: no static activation "
                                     f"scale for {name!r} in "
                                     f"cfg.quant_act_scales")
                layer.act_scale = scales[name]
        self.to(device)

    def int8_layers(self) -> Dict[str, Int8Dense]:
        """The int8 linears by module name (empty unless quantized)."""
        return {name: m for name, m in self.named_modules()
                if isinstance(m, Int8Dense)}

    def encode_times(self, times):
        """[..., 2] interval (start, end) -> [..., d_model] encoding."""
        return self.time_mlp(times.to(self.dtype)).to(self.dtype)

    def drloc(self, x):
        """Concatenated token pairs [..., 4*d_model] -> |dt| predictions."""
        return self.drloc_mlp(x)[..., 0]

    def encoder_forward(self, v_feats, a_feats, time_encodings,
                        num_v_queries: int, num_a_queries: int, *,
                        shared_queries: bool = False,
                        dropout_seed: Optional[int] = None):
        """Returns (cls logits 4-tuple (verb, noun, action, audio), (v_reg,
        a_reg) each [B, Nq, 2], context tokens). ``shared_queries``: set
        only when the query tokens are identical across the batch (dense
        inference grids). ``dropout_seed``: None for the deterministic
        forward, an int for the training forward (module docstring)."""
        gen, layer_seeds = None, None
        if dropout_seed is not None:
            gen = torch.Generator(device=time_encodings.device).manual_seed(
                dropout_seed)
            layer_seeds = [dropout_seed + 1 + i
                           for i in range(len(self.backbone.layers))]
        x = self.feature_encoding(v_feats, a_feats, time_encodings,
                                  num_v_queries, num_a_queries, gen)
        x = self.backbone(x, self.cfg.num_context, shared_queries,
                          layer_seeds)
        cls_scores = self.cls_head(x, num_v_queries, num_a_queries)
        reg_scores = self.reg_head(x, num_v_queries, num_a_queries)
        return cls_scores, reg_scores, x[:, :self.cfg.num_context]
