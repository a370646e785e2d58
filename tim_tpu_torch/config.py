"""Configuration: a copy of ``tim_tpu/config.py``'s ``ModelConfig``,
``DetectionConfig``, ``TrainConfig``, ``MeshConfig`` and the recognition
and detection presets, with the
same field names and defaults, so that one configuration reads the same
in both packages (tests pin the two to equality). ``TrainConfig`` leaves
out the JAX package's two TPU-only fields, ``xla_fusion_cost_model`` and
``rng_impl`` (XLA compiler options and the TPU's random-bit generator).

Frozen dataclasses (hashable); presets are plain functions.

``quant_act_scales`` holds (module name, scale) pairs under the port's
module names (``backbone.layers.0.self_attn.in_proj`` in detection,
``transformer_encoder.layers.0.self_attn.in_proj`` in recognition, ...);
``convert.act_scales_from_jax`` maps the JAX package's param paths to
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the TIM transformer; defaults mirror the reference
    recognition variant: d_model 512, 8 heads, 4 layers, feed-forward
    4*d_model applied to the 2*d_model-wide encoder."""

    # ``visual_classes``: (action,) or (verb, noun, action).
    visual_classes: Tuple[int, ...] = (97, 300, 3806)
    audio_classes: int = 44

    visual_input_dim: int = 1024
    audio_input_dim: int = 2304
    d_model: int = 512
    feedforward_scale: int = 4
    nhead: int = 8
    num_layers: int = 4
    enc_dropout: float = 0.1
    feat_dropout: float = 0.5
    seq_dropout: float = 0.5

    # Modality of the input features and of the queries the model answers
    # ("visual" | "audio" | "audio_visual").
    input_modality: str = "audio_visual"
    data_modality: str = "audio_visual"

    # Context feature tokens per modality in a window.
    num_feats: int = 50
    include_verb_noun: bool = True
    apply_feature_pooling: bool = False

    # Matmuls/activations run in this dtype; params stay fp32.
    compute_dtype: str = "bfloat16"
    remat: bool = False
    # The fused post-attention kernel on inference steps (ignored when
    # quantized, as in the JAX package).
    use_fused_ffn: bool = False
    # Int8 serving: encoder and class-head matmuls run int8.
    quantized_inference: bool = False
    # Calibrated static per-layer activation scales instead of dynamic
    # per-row abs-max.
    quant_static_acts: bool = False
    # (module name, scale) pairs of the calibrated static scales.
    quant_act_scales: Tuple[Tuple[str, float], ...] = ()
    # The fused int8 kernel on the class heads (needs static scales).
    quant_pallas_heads: bool = False
    # bf16 attention scores and softmax (outputs still accumulate fp32).
    fast_scores: bool = False
    dropout_bits: int = 32
    sequence_parallel: bool = False

    @property
    def encoder_width(self) -> int:
        return 2 * self.d_model

    @property
    def num_context(self) -> int:
        """Context tokens seen by the encoder (doubled for audio_visual
        input)."""
        if self.input_modality == "audio_visual":
            return 2 * self.num_feats
        return self.num_feats

    @property
    def vis_mul(self) -> int:
        return 3 if self.include_verb_noun else 1

    def seq_len(self, num_v_queries: int, num_a_queries: int) -> int:
        n = self.num_context
        if "visual" in self.data_modality:
            n += self.vis_mul * num_v_queries
        if "audio" in self.data_modality:
            n += num_a_queries
        return n


@dataclass(frozen=True)
class DetectionConfig(ModelConfig):
    """Detection variant deltas."""

    num_layers: int = 6
    visual_input_dim: int = 2048
    include_verb_noun: bool = False
    dropout_bits: int = 8

    iou_threshold: float = 0.6
    label_smoothing: float = 0.9
    # Smallest query interval (fraction of the window) of the train pool
    # and of the fixed inference grid.
    train_query_size: float = 0.005
    inference_query_size: float = 0.01

    @property
    def vis_mul(self) -> int:
        # detection shares one query token set across verb/noun/action
        return 1


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the reference recipe)."""

    batch_size: int = 64
    epochs: int = 100
    warmup_epochs: int = 2
    lr: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 1e-4
    clip_norm: float = 1.0

    label_smoothing: float = 0.2     # recognition CE smoothing
    mixup_alpha: float = 0.2
    lambda_audio: float = 1.0
    lambda_drloc: float = 0.3
    m_drloc: int = 32

    # Detection-only knobs.
    lambda_reg: float = 0.5
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    normaliser_init: float = 250.0
    normaliser_momentum: float = 0.9

    seed: int = 0
    early_stop_period: int = -1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: ``data`` shards the batch over the processes
    (one card each; -1: the process count over ``model``), ``model`` the
    tensor-parallel axis (``parallel.mesh.make_mesh``)."""

    data: int = -1
    model: int = 1


def epic_recognition(**overrides) -> ModelConfig:
    return dataclasses.replace(ModelConfig(), **overrides)


def epic_visual_only(**overrides) -> ModelConfig:
    cfg = ModelConfig(input_modality="visual", data_modality="visual")
    return dataclasses.replace(cfg, **overrides)


def perception_recognition(**overrides) -> ModelConfig:
    cfg = ModelConfig(visual_classes=(63,), audio_classes=17,
                      include_verb_noun=False)
    return dataclasses.replace(cfg, **overrides)


def ave_recognition(**overrides) -> ModelConfig:
    # AVEL feature widths: VGG 7x7x512 maps (stored flat as [T, A, 49*512])
    # and 128-d audio
    cfg = ModelConfig(visual_classes=(29,), audio_classes=29,
                      include_verb_noun=False, apply_feature_pooling=True,
                      visual_input_dim=512, audio_input_dim=128)
    return dataclasses.replace(cfg, **overrides)


def epic_detection(**overrides) -> DetectionConfig:
    """EPIC-KITCHENS-100 detection: action-only visual heads."""
    cfg = DetectionConfig(visual_classes=(3806,), audio_classes=44)
    return dataclasses.replace(cfg, **overrides)


def perception_detection(**overrides) -> DetectionConfig:
    cfg = DetectionConfig(visual_classes=(63,), audio_classes=17)
    return dataclasses.replace(cfg, **overrides)
