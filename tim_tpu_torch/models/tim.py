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

``mesh`` (a ``parallel.mesh.Mesh`` of several model ranks): the model is
built whole from the generator on every rank, then each rank keeps its
slices of the parameters that ``parallel.mesh.PARTITION_RULES`` shard
(``shard_specs``: the encoder's heads and FFN units, the divisible class
heads' classes; the rest stays replicated), and the encoder and class
heads run on the model axis (``models.transformer``, ``models.heads``),
with ``cfg.sequence_parallel`` the encoder's post-LN regions on a token
shard. ``load_state_dict`` takes the reference's whole tensors and keeps
this rank's slices; ``full_state_dict`` gathers them back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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
from tim_tpu_torch.parallel.mesh import param_specs


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
                 use_verb_noun_cls: bool, prefix_tokens: bool = True,
                 mesh=None):
        super().__init__()
        if mesh is not None and mesh.model_size == 1:
            mesh = None
        if mesh is not None and cfg.quantized_inference:
            raise ValueError(f"{type(self).__name__}: int8 serving runs on "
                             f"one model rank (JAX's rules shard no int8 "
                             f"layer); mesh model axis {mesh.model_size}")
        self.mesh = mesh
        self.shard_specs: Dict[str, Tuple[int, int]] = {}
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
        """Set the static activation scales, keep this rank's slices on a
        model axis and move to the device. Each sliced parameter carries
        the mesh as ``model_mesh`` (the optimizer's global norm and
        non-finite test reduce over its model ranks:
        ``train.optim.AdamWIfFinite``)."""
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
        if self.mesh is not None:
            self._shard()
        self.to(self._device)
        for name in self.shard_specs:
            self.get_parameter(name).model_mesh = self.mesh

    def _shard(self) -> None:
        """Slice the parameters that the rules shard (heads the model axis
        does not divide keep the attention replicated) and put the
        encoder and class heads on the model axis."""
        mesh = self.mesh
        specs = param_specs({n: p.shape for n, p in self.named_parameters()},
                            mesh.model_size)
        if self.cfg.nhead % mesh.model_size:
            specs = {n: s for n, s in specs.items() if ".self_attn." not in n}
        with torch.no_grad():
            for name, (dim, blocks) in specs.items():
                p = self.get_parameter(name)
                p.data = mesh.local_slice(p.data, dim, blocks).clone()
        self.shard_specs = specs
        prefix = f"{self.ENCODER}."
        self.encoder.shard(mesh, self.cfg.sequence_parallel, {
            n[len(prefix):] for n in specs if n.startswith(prefix)})
        self.cls_head.shard(mesh, {
            n.split(".")[1] for n in specs if n.startswith("cls_head.")})

    def shard_state_dict(self, state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """``state_dict`` with this rank's slice of each whole tensor that
        the model holds sharded (a slice already sharded is kept)."""
        out = dict(state_dict)
        own = dict(self.named_parameters())
        for name, (dim, blocks) in self.shard_specs.items():
            t = out.get(name)
            if t is not None and t.shape != own[name].shape:
                out[name] = self.mesh.local_slice(t, dim, blocks)
        return out

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict`` of whole (reference) or sharded
        tensors: on a model axis each rank keeps its slices."""
        return super().load_state_dict(self.shard_state_dict(state_dict),
                                       strict=strict, assign=assign)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference-named state dict of whole tensors (on a model
        axis: the sharded ones gathered over the model ranks, one
        collective every rank joins)."""
        out = self.state_dict()
        if self.shard_specs:
            names = list(self.shard_specs)
            whole = self.mesh.gather_params(
                [(out[n].detach(), *self.shard_specs[n]) for n in names])
            out.update(zip(names, whole))
        return out

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
                 generator: Optional[torch.Generator] = None, mesh=None):
        single = (cfg.input_modality != "audio_visual"
                  and cfg.data_modality == cfg.input_modality)
        super().__init__(cfg, device=device, generator=generator,
                         use_verb_noun_cls=cfg.include_verb_noun,
                         prefix_tokens=not single, mesh=mesh)
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
    heads, and the drloc MLP of the training loss. Device, init, mesh and
    quantization as ``_TimBase``; ``cfg.quant_pallas_heads`` fuses the
    int8 class heads (kernel 3 on the card)."""

    def __init__(self, cfg: DetectionConfig, *,
                 device: Optional[torch.device | str] = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__(cfg, device=device, generator=generator,
                         use_verb_noun_cls=False, mesh=mesh)
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
