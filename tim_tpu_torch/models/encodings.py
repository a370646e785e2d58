"""Feature + CLS-token sequence assembly: counterpart of
``tim_tpu/models/encodings.py``, detection layout (no verb/noun CLS sets).

- per-modality embedder: Dropout -> Linear(D_in -> d) -> GELU -> LayerNorm;
- time encodings are concatenated channel-wise (tokens become 2d wide);
- learnable modality embeddings are added (audio_visual input only);
- learnable CLS tokens are expanded per query and concatenated with the
  query-interval time encodings.

Sequence: [vis*F | aud*F | visual_action_cls*Nv | audio_action_cls*Na].
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tim_tpu_torch.models.common import (
    TORCH_LINEAR, LayerNorm, TorchLinear, exact_gelu)


class ExactGelu(nn.Module):
    """``exact_gelu`` as a parameter-free module (bf16: JAX's rounding)."""

    def forward(self, x):
        return exact_gelu(x)


class FeatureEmbedder(nn.Sequential):
    """Indices follow the reference: 0 dropout slot (identity at
    inference), 1 Linear, 2 GELU, 3 LayerNorm."""

    def __init__(self, in_dim: int, d_model: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__(
            nn.Identity(),
            TorchLinear(in_dim, d_model, dtype=dtype, generator=generator,
                        rounding=TORCH_LINEAR),
            ExactGelu(),
            LayerNorm(d_model))
        self.dtype = dtype

    def forward(self, x):
        return super().forward(x.to(self.dtype)).to(self.dtype)


def _token(shape, generator):
    return nn.Parameter(torch.empty(shape).normal_(0.0, 0.01,
                                                   generator=generator))


class FeatureEncoding(nn.Module):
    """Builds the [B, S, 2*d_model] token sequence for the encoder."""

    def __init__(self, d_model: int, input_modality: str,
                 data_modality: str, num_feats: int, visual_input_dim: int,
                 audio_input_dim: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.d_model = d_model
        self.input_modality = input_modality
        self.data_modality = data_modality
        self.num_feats = num_feats
        self.dtype = dtype
        wide = 2 * d_model
        if "visual" in input_modality:
            self.visual_embedder = FeatureEmbedder(
                visual_input_dim, d_model, dtype=dtype, generator=generator)
        if "audio" in input_modality:
            self.audio_embedder = FeatureEmbedder(
                audio_input_dim, d_model, dtype=dtype, generator=generator)
        if input_modality == "audio_visual":
            self.visual_modality_encoding = _token((1, 1, wide), generator)
            self.audio_modality_encoding = _token((1, 1, wide), generator)
        if "visual" in data_modality:
            self.visual_action_cls = _token((1, 1, d_model), generator)
        if "audio" in data_modality:
            self.audio_action_cls = _token((1, 1, d_model), generator)

    def forward(self, v_feats, a_feats, time_encodings, num_v_queries: int,
                num_a_queries: int):
        """v_feats/a_feats: [B, F, D] or None; time_encodings [B, T, d]:
        the first rows encode feature times, the rest query intervals
        (visual then audio). Returns [B, S, 2*d_model]."""
        dt = self.dtype
        av = self.input_modality == "audio_visual"
        nf = self.num_feats
        te = time_encodings.to(dt)
        parts = []
        offset = 0
        for mod, feats in (("visual", v_feats), ("audio", a_feats)):
            if mod not in self.input_modality:
                continue
            x = getattr(self, f"{mod}_embedder")(feats)
            x = torch.cat([x, te[:, offset:offset + nf]], dim=-1)
            if av:
                x = x + getattr(self, f"{mod}_modality_encoding").to(dt)
            parts.append(x)
            offset += nf

        query_te = te[:, offset:]
        batch = time_encodings.shape[0]

        def cls_tokens(token, n, t_enc, modality_enc):
            tok = token.to(dt).expand(batch, n, self.d_model)
            tok = torch.cat([tok, t_enc], dim=-1)
            if modality_enc is not None:
                tok = tok + modality_enc.to(dt)
            return tok

        if "visual" in self.data_modality and num_v_queries > 0:
            parts.append(cls_tokens(
                self.visual_action_cls, num_v_queries,
                query_te[:, :num_v_queries],
                self.visual_modality_encoding if av else None))
        if "audio" in self.data_modality and num_a_queries > 0:
            parts.append(cls_tokens(
                self.audio_action_cls, num_a_queries,
                query_te[:, -num_a_queries:],
                self.audio_modality_encoding if av else None))
        return torch.cat(parts, dim=1)
