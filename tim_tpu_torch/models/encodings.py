"""Feature + CLS-token sequence assembly: counterpart of
``tim_tpu/models/encodings.py``.

- per-modality embedder: Dropout -> Linear(D_in -> d) -> GELU -> LayerNorm;
- time encodings are concatenated channel-wise (tokens become 2d wide);
- learnable modality embeddings are added (audio_visual input only);
- learnable CLS tokens are expanded per query and concatenated with the
  query-interval time encodings.

Sequence (recognition, ``use_verb_noun_cls``):
  [vis*F | aud*F | verb_cls*Nv | noun_cls*Nv | action_cls*Nv | audio_cls*Na];
detection drops the verb/noun CLS sets. The heads slice from the tail in
this order.

Token names are the reference's: ``visual_{verb,noun,action}_cls`` and
``audio_action_cls``; a recognition model whose input and queries are of
one modality (visual-only, audio-only) names them without the modality
prefix (``verb_cls``, ``noun_cls``, ``action_cls``), as the reference does
(``prefix_tokens=False``).

Training (a ``generator`` given): Bernoulli dropout (flax ``nn.Dropout``,
whatever ``dropout_bits`` says, as in JAX) of ``feat_dropout`` on each
embedder's input (slot 0 of its Sequential) and of ``seq_dropout`` on
the assembled sequence.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tim_tpu_torch.models.common import (
    TORCH_LINEAR, LayerNorm, TorchLinear, exact_gelu)
from tim_tpu_torch.ops.dropout import dropout


class ExactGelu(nn.Module):
    """``exact_gelu`` as a parameter-free module (bf16: JAX's rounding)."""

    def forward(self, x):
        return exact_gelu(x)


class Dropout(nn.Module):
    """Bernoulli dropout of ``rate``, parameter-free: identity unless a
    generator is given."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, generator is None, 32, generator)


class FeatureEmbedder(nn.Sequential):
    """Indices follow the reference: 0 dropout, 1 Linear, 2 GELU, 3
    LayerNorm."""

    def __init__(self, in_dim: int, d_model: int, *, dtype: torch.dtype,
                 generator: torch.Generator, feat_dropout: float = 0.5):
        super().__init__(
            Dropout(feat_dropout),
            TorchLinear(in_dim, d_model, dtype=dtype, generator=generator,
                        rounding=TORCH_LINEAR),
            ExactGelu(),
            LayerNorm(d_model))
        self.dtype = dtype

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self[0](x.to(self.dtype), generator)
        return self[3](self[2](self[1](x))).to(self.dtype)


def _token(shape, generator):
    return nn.Parameter(torch.empty(shape).normal_(0.0, 0.01,
                                                   generator=generator))


class FeatureEncoding(nn.Module):
    """Builds the [B, S, 2*d_model] token sequence for the encoder."""

    def __init__(self, d_model: int, input_modality: str,
                 data_modality: str, num_feats: int, visual_input_dim: int,
                 audio_input_dim: int, *, dtype: torch.dtype,
                 generator: torch.Generator, feat_dropout: float = 0.5,
                 seq_dropout: float = 0.5, use_verb_noun_cls: bool = False,
                 prefix_tokens: bool = True):
        super().__init__()
        self.d_model = d_model
        self.use_verb_noun_cls = use_verb_noun_cls
        self._token_names = {} if prefix_tokens else {
            "visual_verb_cls": "verb_cls", "visual_noun_cls": "noun_cls",
            "visual_action_cls": "action_cls",
            "audio_action_cls": "action_cls"}
        self.input_modality = input_modality
        self.data_modality = data_modality
        self.num_feats = num_feats
        self.dtype = dtype
        self.seq_dropout = Dropout(seq_dropout)
        wide = 2 * d_model
        if "visual" in input_modality:
            self.visual_embedder = FeatureEmbedder(
                visual_input_dim, d_model, dtype=dtype, generator=generator,
                feat_dropout=feat_dropout)
        if "audio" in input_modality:
            self.audio_embedder = FeatureEmbedder(
                audio_input_dim, d_model, dtype=dtype, generator=generator,
                feat_dropout=feat_dropout)
        if input_modality == "audio_visual":
            self.visual_modality_encoding = _token((1, 1, wide), generator)
            self.audio_modality_encoding = _token((1, 1, wide), generator)
        tokens = []
        if "visual" in data_modality:
            tokens.append("visual_action_cls")
            if use_verb_noun_cls:
                tokens += ["visual_verb_cls", "visual_noun_cls"]
        if "audio" in data_modality:
            tokens.append("audio_action_cls")
        for name in tokens:
            setattr(self, self._token_names.get(name, name),
                    _token((1, 1, d_model), generator))

    def cls_token(self, name: str) -> torch.Tensor:
        """The CLS token ``name`` (its prefixed name), whatever it is
        called in the state dict."""
        return getattr(self, self._token_names.get(name, name))

    def forward(self, v_feats, a_feats, time_encodings, num_v_queries: int,
                num_a_queries: int,
                generator: Optional[torch.Generator] = None):
        """v_feats/a_feats: [B, F, D] or None; time_encodings [B, T, d]:
        the first rows encode feature times, the rest query intervals
        (visual then audio). ``generator``: the dropout generator
        (training), else None. Returns [B, S, 2*d_model]."""
        dt = self.dtype
        av = self.input_modality == "audio_visual"
        nf = self.num_feats
        te = time_encodings.to(dt)
        parts = []
        offset = 0
        for mod, feats in (("visual", v_feats), ("audio", a_feats)):
            if mod not in self.input_modality:
                continue
            x = getattr(self, f"{mod}_embedder")(feats, generator)
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
            names = (("visual_verb_cls", "visual_noun_cls")
                     if self.use_verb_noun_cls else ())
            for name in names + ("visual_action_cls",):
                parts.append(cls_tokens(
                    self.cls_token(name), num_v_queries,
                    query_te[:, :num_v_queries],
                    self.visual_modality_encoding if av else None))
        if "audio" in self.data_modality and num_a_queries > 0:
            parts.append(cls_tokens(
                self.cls_token("audio_action_cls"), num_a_queries,
                query_te[:, -num_a_queries:],
                self.audio_modality_encoding if av else None))
        return self.seq_dropout(torch.cat(parts, dim=1), generator)
