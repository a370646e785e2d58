"""Fused end-to-end pipelines: raw clips -> backbone features -> TIM, as
one module. Counterpart of ``tim_tpu/models/fused.py``.

Every window carries ``num_feats`` feature timestamps; each timestamp has
one video clip and one audio spectrogram. The backbones run on the
flattened [B * F] clip batch, then TIM takes the reassembled [B, F, D]
feature tokens. The pipelines are ``nn.Module``s that own their backbones,
SlowFast and TIM (no ``variables`` argument): pass built ones (e.g. a
``quantized=True`` Swin or ViT, or a SlowFast of another size) or let the
pipeline build the defaults (Swin-B, ViT-L in the TIM compute dtype,
Auditory SlowFast at its EPIC-Sounds size) from ``generator``, on
``device`` (the card unless given; raises without one). Built backbones
run their forwards under ``torch.inference_mode`` (eval mode): serve
through the pipeline under it too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tim_tpu_torch.config import ModelConfig
from tim_tpu_torch.models.backbones.slowfast import (
    AuditorySlowFast, pack_pathways)
from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D
from tim_tpu_torch.models.backbones.vit import VideoMAEViT
from tim_tpu_torch.models.tim import (
    TimDetection, TimRecognition, resolve_device)


class FusedRecognitionPipeline(nn.Module):
    """Raw media -> TIM recognition logits.

    ``visual_backbone``: 'omnivore', 'videomae', or 'both' (features
    concatenated, the merge_features layout); ``tim_cfg.visual_input_dim``
    must match the produced feature width."""

    TIM = TimRecognition

    def __init__(self, tim_cfg: ModelConfig, visual_backbone: str = "both",
                 swin: Optional[nn.Module] = None,
                 vit: Optional[nn.Module] = None,
                 audio: Optional[nn.Module] = None, audio_alpha: int = 4, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        cfg = self.tim_cfg = tim_cfg
        self.visual_backbone = visual_backbone
        self.audio_alpha = audio_alpha
        if "visual" in cfg.input_modality:
            if visual_backbone in ("omnivore", "both"):
                self.swin_model = swin if swin is not None else \
                    SwinTransformer3D(dtype=cfg.compute_dtype, device=device,
                                      generator=gen)
            if visual_backbone in ("videomae", "both"):
                self.vit_model = vit if vit is not None else VideoMAEViT(
                    dtype=cfg.compute_dtype, device=device, generator=gen)
        if "audio" in cfg.input_modality:
            self.audio_model = audio if audio is not None else \
                AuditorySlowFast(alpha=audio_alpha, device=device,
                                 generator=gen)
        self.tim = self.TIM(cfg, device=device, generator=gen)

    def extract_visual(self, clips):
        """[B, F, T, H, W, 3] -> [B, F, Dv]."""
        b, f = clips.shape[:2]
        flat = clips.reshape((b * f,) + tuple(clips.shape[2:]))
        feats = []
        if self.visual_backbone in ("omnivore", "both"):
            feats.append(self.swin_model(flat))
        if self.visual_backbone in ("videomae", "both"):
            feats.append(self.vit_model(flat))
        out = torch.cat(feats, dim=-1)
        return out.reshape(b, f, out.shape[-1])

    def extract_audio(self, spectrograms):
        """[B, F, T_spec, n_mels] -> [B, F, 2304] (SlowFast's feature)."""
        b, f = spectrograms.shape[:2]
        flat = spectrograms.reshape((b * f, 1) + tuple(spectrograms.shape[2:]))
        _, feats = self.audio_model(
            *pack_pathways(flat.float(), alpha=self.audio_alpha))
        return feats.reshape(b, f, feats.shape[-1])

    def _features(self, video_clips, audio_specs):
        v_feats = a_feats = None
        if "visual" in self.tim_cfg.input_modality:
            v_feats = self.extract_visual(video_clips)
        if "audio" in self.tim_cfg.input_modality:
            a_feats = self.extract_audio(audio_specs)
        return v_feats, a_feats

    def forward(self, video_clips, audio_specs, times, num_v_queries: int,
                num_a_queries: int, *, dropout_seed: Optional[int] = None):
        """((verb, noun, action, audio) logits, context tokens);
        ``dropout_seed`` as ``TimRecognition.forward``'s (None: the
        deterministic forward)."""
        v_feats, a_feats = self._features(video_clips, audio_specs)
        return self.tim(v_feats, a_feats, times, num_v_queries,
                        num_a_queries, dropout_seed=dropout_seed)


class FusedDetectionPipeline(FusedRecognitionPipeline):
    """Raw media -> dense detection proposals: clips and spectrograms
    through the backbones, features through the detection TIM
    (``TimDetection.encode_times`` / ``encoder_forward``). ``times``
    carries the feature timestamps followed by the query intervals
    (visual, then audio), as ``TimDetection`` expects."""

    TIM = TimDetection

    def forward(self, video_clips, audio_specs, times, num_v_queries: int,
                num_a_queries: int, *, shared_queries: bool = False,
                dropout_seed: Optional[int] = None):
        """(cls logits 4-tuple, (v_reg, a_reg), context tokens)."""
        v_feats, a_feats = self._features(video_clips, audio_specs)
        te = self.tim.encode_times(times)
        return self.tim.encoder_forward(
            v_feats, a_feats, te, num_v_queries, num_a_queries,
            shared_queries=shared_queries, dropout_seed=dropout_seed)
