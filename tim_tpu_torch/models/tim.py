"""TIM models: counterpart of ``tim_tpu/models/tim.py``: ``TimRecognition``
and ``TimDetection`` on one shared trunk (the time MLP, the feature
encoding, the encoder, the drloc MLP and, for AVE, AVGA pooling).

Parameter names follow the reference torch ``state_dict``
(``tim_tpu/convert/torch_import.py`` reads the same layout), so released
checkpoints load with ``load_state_dict(strict=True)``: ``time_mlp.{0,2,4,6}``,
``feature_encoding.*``, the encoder (``transformer_encoder.layers.N.*`` in
recognition, ``backbone.layers.N.*`` in detection), ``cls_head.fc_*``,
``drloc_mlp.{0,2,4}``, and ``pool.*`` (recognition with
``apply_feature_pooling``) or ``reg_head.fc_*_action.{0,2,4}`` (detection).

``encoder_forward(..., dropout_seed=None)`` is the deterministic
(inference, validation) forward; an int ``dropout_seed`` makes it the
training forward: the feature encoding's dropout draws from a device
generator seeded ``dropout_seed``, encoder layer i's from one seeded
``dropout_seed + 1 + i`` (its own, so that ``remat`` replays it). With
``dropout_rows`` (this rank's first row, the global batch's rows) each
mask is drawn for the global batch and this rank keeps its rows
(``ops.dropout.BatchRows``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tim_tpu_torch.config import DetectionConfig, ModelConfig
from tim_tpu_torch.models.common import MLP, Int8Dense, LayerNorm, dtype_of
from tim_tpu_torch.models.encodings import FeatureEncoding
from tim_tpu_torch.models.heads import (
    DetectionClsHead, DetectionRegHead, RecognitionClsHead)
from tim_tpu_torch.models.pool import AVGA
from tim_tpu_torch.models.transformer import Encoder
from tim_tpu_torch.ops.dropout import layer_generator

# Config options whose code paths are not ported yet, with the value the
# port supports.
_UNPORTED = {"sequence_parallel": False}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and a CUDA
    device without a card raises (pass ``device="cpu"`` for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           f"torch.cuda.is_available() is false; pass "
                           f"device='cpu' to run on the CPU")
    return device


class _TimBase(nn.Module):
    """The shared trunk. ``device``: the CUDA card by default (raises
    without one); the CPU only when asked for. ``generator`` seeds the
    random init (a fresh generator seeded 0 when None); parameters are
    built on the CPU, and ``_finish`` moves them to the device once the
    subclass has added its heads.

    ``cfg.quantized_inference``: the encoder linears and class heads are
    ``Int8Dense`` (load ``ops.quant.quantize_state_dict`` weights), with
    dynamic activation scales, or with ``quant_static_acts`` the static
    scales of ``cfg.quant_act_scales`` (a layer without one raises)."""

    # the encoder's name in the reference's state dict
    ENCODER = "backbone"

    def __init__(self, cfg: ModelConfig, *, device, generator,
                 use_verb_noun_cls: bool, prefix_tokens: bool = True):
        super().__init__()
        for name, value in _UNPORTED.items():
            if getattr(cfg, name) != value:
                raise ValueError(f"{type(self).__name__}: {name}="
                                 f"{getattr(cfg, name)!r} is not ported "
                                 f"(supported: {value!r})")
        self._device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = dt = dtype_of(cfg)
        d = cfg.d_model
        width = cfg.encoder_width
        g = self._generator = generator

        # Linear(2->d) -> ReLU x3 -> LayerNorm (time_mlp.6)
        self.time_mlp = nn.Sequential(
            *MLP((2, d, d, d), dtype=dt, generator=g, final=nn.ReLU()),
            LayerNorm(d))
        self.feature_encoding = FeatureEncoding(
            d, cfg.input_modality, cfg.data_modality, cfg.num_feats,
            cfg.visual_input_dim, cfg.audio_input_dim, dtype=dt, generator=g,
            feat_dropout=cfg.feat_dropout, seq_dropout=cfg.seq_dropout,
            use_verb_noun_cls=use_verb_noun_cls, prefix_tokens=prefix_tokens)
        setattr(self, self.ENCODER, Encoder(
            width, cfg.nhead, d * cfg.feedforward_scale, cfg.num_layers,
            dtype=dt, fused=cfg.use_fused_ffn, generator=g,
            quantized=cfg.quantized_inference, fast_scores=cfg.fast_scores,
            dropout_rate=cfg.enc_dropout, dropout_bits=cfg.dropout_bits,
            remat=cfg.remat))
        # Linear(4d->d) -> ReLU -> Linear(d->d) -> ReLU -> Linear(d->1)
        self.drloc_mlp = MLP((2 * width, d, d, 1), dtype=dt, generator=g)
        if cfg.apply_feature_pooling:
            self.pool = AVGA(cfg.visual_input_dim, cfg.audio_input_dim,
                             dtype=dt, generator=g)

    def _finish(self) -> None:
        """Set the static activation scales and move to the device."""
        cfg = self.cfg
        if cfg.quantized_inference and cfg.quant_static_acts:
            scales = dict(cfg.quant_act_scales)
            for name, layer in self.int8_layers().items():
                if name not in scales:
                    raise ValueError(f"{type(self).__name__}: no static "
                                     f"activation scale for {name!r} in "
                                     f"cfg.quant_act_scales")
                layer.act_scale = scales[name]
        del self._generator
        self.to(self._device)

    @property
    def encoder(self) -> Encoder:
        return getattr(self, self.ENCODER)

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

    def _encode_sequence(self, v_feats, a_feats, time_encodings,
                         num_v_queries: int, num_a_queries: int,
                         shared_queries: bool, dropout_seed: Optional[int],
                         dropout_rows: Optional[Tuple[int, int]] = None):
        """The encoder's output [B, S, 2*d_model]."""
        cfg = self.cfg
        gen, layer_seeds = None, None
        if dropout_seed is not None:
            gen = layer_generator(dropout_seed, time_encodings.device,
                                  dropout_rows)
            layer_seeds = [dropout_seed + 1 + i
                           for i in range(len(self.encoder.layers))]
        if cfg.apply_feature_pooling:
            if v_feats.ndim == 3:
                # the AVE layout keeps the 7x7 map flattened into the
                # channels ([T, A, P*Dv]); unflatten before pooling
                b, t = v_feats.shape[:2]
                v_feats = v_feats.reshape(b, t, -1, cfg.visual_input_dim)
            v_feats = self.pool(a_feats, v_feats)
        x = self.feature_encoding(v_feats, a_feats, time_encodings,
                                  num_v_queries, num_a_queries, gen)
        return self.encoder(x, cfg.num_context, shared_queries, layer_seeds,
                            dropout_rows)


class TimRecognition(_TimBase):
    """Recognition variant: per-task CLS query tokens (verb, noun and
    action with ``include_verb_noun``) and linear heads."""

    ENCODER = "transformer_encoder"

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[torch.device | str] = None,
                 generator: Optional[torch.Generator] = None):
        single = (cfg.input_modality != "audio_visual"
                  and cfg.data_modality == cfg.input_modality)
        super().__init__(cfg, device=device, generator=generator,
                         use_verb_noun_cls=cfg.include_verb_noun,
                         prefix_tokens=not single)
        vis = (cfg.visual_classes if "visual" in cfg.data_modality
               else None)
        aud = cfg.audio_classes if "audio" in cfg.data_modality else None
        self.cls_head = RecognitionClsHead(
            cfg.encoder_width, vis, aud, dtype=self.dtype,
            generator=self._generator, quantized=cfg.quantized_inference)
        self._finish()

    def encoder_forward(self, v_feats, a_feats, time_encodings,
                        num_v_queries: int, num_a_queries: int, *,
                        dropout_seed: Optional[int] = None,
                        dropout_rows: Optional[Tuple[int, int]] = None):
        """Returns ((verb, noun, action, audio) logits, each [B, Nq, C] or
        None, context tokens [B, num_context, 2*d_model]).
        ``dropout_seed``: None for the deterministic forward, an int for
        the training forward; ``dropout_rows``: several processes (module
        docstring)."""
        x = self._encode_sequence(v_feats, a_feats, time_encodings,
                                  num_v_queries, num_a_queries, False,
                                  dropout_seed, dropout_rows)
        logits = self.cls_head(x, num_v_queries, num_a_queries)
        return logits, x[:, :self.cfg.num_context]

    def forward(self, v_feats, a_feats, times, num_v_queries: int,
                num_a_queries: int, *, dropout_seed: Optional[int] = None):
        """The full forward: ``times`` [B, T, 2] holds the feature times,
        then the query intervals (visual, then audio)."""
        return self.encoder_forward(
            v_feats, a_feats, self.encode_times(times), num_v_queries,
            num_a_queries, dropout_seed=dropout_seed)


class TimDetection(_TimBase):
    """Detection variant: shared query tokens, cls + interval-regression
    heads, and the drloc MLP of the training loss. Device, init and
    quantization as ``_TimBase``; ``cfg.quant_pallas_heads`` fuses the
    int8 class heads (kernel 3 on the card)."""

    def __init__(self, cfg: DetectionConfig, *,
                 device: Optional[torch.device | str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device=device, generator=generator,
                         use_verb_noun_cls=False)
        width = cfg.encoder_width
        vis = (cfg.visual_classes if "visual" in cfg.data_modality
               else None)
        aud = cfg.audio_classes if "audio" in cfg.data_modality else None
        self.cls_head = DetectionClsHead(
            width, vis, aud, dtype=self.dtype, generator=self._generator,
            quantized=cfg.quantized_inference,
            pallas_fused=cfg.quant_pallas_heads)
        self.reg_head = DetectionRegHead(width, vis is not None,
                                         aud is not None, dtype=self.dtype,
                                         generator=self._generator)
        self._finish()

    def encoder_forward(self, v_feats, a_feats, time_encodings,
                        num_v_queries: int, num_a_queries: int, *,
                        shared_queries: bool = False,
                        dropout_seed: Optional[int] = None,
                        dropout_rows: Optional[Tuple[int, int]] = None):
        """Returns (cls logits 4-tuple (verb, noun, action, audio), (v_reg,
        a_reg) each [B, Nq, 2], context tokens). ``shared_queries``: set
        only when the query tokens are identical across the batch (dense
        inference grids). ``dropout_seed``: None for the deterministic
        forward, an int for the training forward; ``dropout_rows``:
        several processes (module docstring)."""
        x = self._encode_sequence(v_feats, a_feats, time_encodings,
                                  num_v_queries, num_a_queries,
                                  shared_queries, dropout_seed, dropout_rows)
        cls_scores = self.cls_head(x, num_v_queries, num_a_queries)
        reg_scores = self.reg_head(x, num_v_queries, num_a_queries)
        return cls_scores, reg_scores, x[:, :self.cfg.num_context]
