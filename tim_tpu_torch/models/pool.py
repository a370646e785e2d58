"""Audio-guided visual attention pooling (AVGA, from AVEL, ECCV'18):
counterpart of ``tim_tpu/models/pool.py``.

Used only on AVE with ``apply_feature_pooling``: each timestep's 7x7
visual feature map is pooled into one vector by attention weights that the
audio feature of the same timestep guides. Parameter names follow the
reference's ``pool.*`` (``affine_audio``, ``affine_video`` with biases;
``affine_v``, ``affine_g``, ``affine_h`` without). The linears round as
flax ``nn.Dense`` (``DENSE``); in bf16 every step runs in bf16, as JAX's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tim_tpu_torch.models.common import DENSE, TorchLinear, uniform_


def _xavier(in_features: int, out_features: int, *, dtype: torch.dtype,
            generator: torch.Generator, use_bias: bool) -> TorchLinear:
    """A DENSE linear with JAX's init: xavier-uniform weight, zero bias."""
    layer = TorchLinear(in_features, out_features, dtype=dtype,
                        generator=generator, rounding=DENSE,
                        bias_value=0.0, use_bias=use_bias)
    uniform_(layer.weight, math.sqrt(6.0 / (in_features + out_features)),
             generator)
    return layer


class AVGA(nn.Module):
    def __init__(self, hidden_size: int, audio_dim: int, *,
                 dtype: torch.dtype, generator: torch.Generator,
                 map_size: int = 49):
        super().__init__()
        self.map_size = map_size
        self.dtype = dtype
        g = generator
        self.affine_audio = _xavier(audio_dim, hidden_size, dtype=dtype,
                                    generator=g, use_bias=True)
        self.affine_video = _xavier(hidden_size, hidden_size, dtype=dtype,
                                    generator=g, use_bias=True)
        self.affine_v = _xavier(hidden_size, map_size, dtype=dtype,
                                generator=g, use_bias=False)
        self.affine_g = _xavier(hidden_size, map_size, dtype=dtype,
                                generator=g, use_bias=False)
        self.affine_h = _xavier(map_size, 1, dtype=dtype, generator=g,
                                use_bias=False)

    def forward(self, audio, video):
        """audio [B, T, Da], video [B, T, P, Dv] (P spatial positions) ->
        the attended video [B, T, Dv] in the compute dtype."""
        b, t, p, dv = video.shape
        if p != self.map_size:
            raise ValueError(f"AVGA requires P == map_size "
                             f"({self.map_size}); got P={p}. The AVEL "
                             f"design ties the attention projection to a "
                             f"7x7 grid")
        v = video.reshape(b * t, p, dv).to(self.dtype)
        a = audio.reshape(b * t, -1).to(self.dtype)
        v_h = torch.relu(self.affine_video(v))
        a_h = torch.relu(self.affine_audio(a))
        content = self.affine_v(v_h) + self.affine_g(a_h)[:, :, None]
        z = self.affine_h(torch.tanh(content))[..., 0]          # [B*T, P]
        # jax.nn.softmax: each step in the compute dtype
        e = torch.exp(z - z.amax(-1, keepdim=True))
        alpha = e / e.sum(-1, keepdim=True)
        pooled = torch.matmul(alpha[:, None, :], v)[:, 0]        # [B*T, Dv]
        return pooled.reshape(b, t, dv)
