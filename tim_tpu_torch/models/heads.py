"""Detection heads: counterpart of ``tim_tpu/models/heads.py``.

The classifier shares the visual query tokens across its verb/noun/action
linears, whose bias starts at the RetinaNet focal prior; the regression
head is a 3-layer sigmoid MLP per modality giving a normalised
[start, end]. Outputs keep the [B, Nq, C] shape.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tim_tpu_torch.models.common import DENSE, MLP, Int8Dense, TorchLinear

FOCAL_BIAS = -math.log((1 - 0.01) / 0.01)


def _query_slices(s: int, num_v_queries: int, num_a_queries: int):
    aud_start = s - num_a_queries if num_a_queries > 0 else s
    return aud_start - num_v_queries, aud_start


class DetectionClsHead(nn.Module):
    """``fc_visual_{verb,noun,action}`` and ``fc_audio_action``; with
    ``quantized`` each is an ``Int8Dense``, fused (kernel 3 on the card
    once its static scale is set) with ``pallas_fused``."""

    def __init__(self, d_model: int,
                 visual_classes: Optional[Tuple[int, ...]],
                 audio_classes: Optional[int], *, dtype: torch.dtype,
                 generator: torch.Generator, quantized: bool = False,
                 pallas_fused: bool = False):
        super().__init__()

        def focal(n):
            if quantized:
                return Int8Dense(d_model, n, dtype=dtype,
                                 pallas_fused=pallas_fused)
            return TorchLinear(d_model, n, dtype=dtype, generator=generator,
                               rounding=DENSE, bias_value=FOCAL_BIAS)

        self.include_vn = (visual_classes is not None
                           and len(visual_classes) == 3)
        if visual_classes is not None:
            if self.include_vn:
                self.fc_visual_verb = focal(visual_classes[0])
                self.fc_visual_noun = focal(visual_classes[1])
            self.fc_visual_action = focal(visual_classes[-1])
        if audio_classes is not None:
            self.fc_audio_action = focal(audio_classes)

    def forward(self, x, num_v_queries: int, num_a_queries: int):
        vis_start, aud_start = _query_slices(x.shape[1], num_v_queries,
                                             num_a_queries)
        verb = noun = action = audio = None
        if hasattr(self, "fc_visual_action") and num_v_queries > 0:
            vx = x[:, vis_start:aud_start]
            if self.include_vn:
                verb = self.fc_visual_verb(vx)
                noun = self.fc_visual_noun(vx)
            action = self.fc_visual_action(vx)
        if hasattr(self, "fc_audio_action") and num_a_queries > 0:
            audio = self.fc_audio_action(x[:, aud_start:])
        return verb, noun, action, audio


class DetectionRegHead(nn.Module):
    """``fc_{visual,audio}_action``: Linear -> ReLU -> Linear -> ReLU ->
    Linear(->2) -> Sigmoid over the encoder width."""

    def __init__(self, d_model: int, has_visual: bool, has_audio: bool, *,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        dims = (d_model, d_model // 2, d_model // 2, 2)
        if has_visual:
            self.fc_visual_action = MLP(dims, dtype=dtype, generator=generator,
                                        final=nn.Sigmoid())
        if has_audio:
            self.fc_audio_action = MLP(dims, dtype=dtype, generator=generator,
                                       final=nn.Sigmoid())

    def forward(self, x, num_v_queries: int, num_a_queries: int):
        vis_start, aud_start = _query_slices(x.shape[1], num_v_queries,
                                             num_a_queries)
        v_reg = a_reg = None
        if hasattr(self, "fc_visual_action") and num_v_queries > 0:
            v_reg = self.fc_visual_action(x[:, vis_start:aud_start])
        if hasattr(self, "fc_audio_action") and num_a_queries > 0:
            a_reg = self.fc_audio_action(x[:, aud_start:])
        return v_reg, a_reg
