"""VideoMAE vision transformer: counterpart of
``tim_tpu/models/backbones/vit.py``.

Tubelet Conv3D patch embedding, a fixed sin-cos position table, pre-norm
ViT blocks with VideoMAE's packed qkv (q and v biases, no k bias) and
optional layer scale, the mean-pooled ``forward_features`` -> ``fc_norm``
(1024-d for ViT-L, ``videomae_vit_large``). LayerNorms use eps 1e-6.

Parameter names are the reference checkpoint's, the keys that
``vit.params_from_torch`` reads: ``patch_embed.proj``,
``blocks.{i}.{norm1, attn.qkv.weight, attn.q_bias, attn.v_bias,
attn.proj, norm2, mlp.fc1, mlp.fc2, gamma_1, gamma_2}`` and ``fc_norm``.

The attention core is ``ops.flash_mha`` (kernel 5 on the card, forward
and backward). The model is built in eval mode, where its forward runs
under ``torch.inference_mode`` (feature extraction); after ``.train()``
and with grad enabled it records autograd. ``remat_mlp`` recomputes each
block's norm2 + MLP in the backward (``torch.utils.checkpoint``, the
attention kernel outside it, as ``ViTBlock.remat_mlp`` in JAX); ``remat``
recomputes whole blocks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tim_tpu_torch.models.common import (
    DENSE, TORCH_LINEAR, GeluMlp, LayerNorm, PatchEmbed3D, TorchLinear,
    inference_unless_training, linear, uniform_)
from tim_tpu_torch.models.tim import resolve_device
from tim_tpu_torch.ops.flash_mha import flash_mha_qkv

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-6


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Classic sin/cos table (``modeling_finetune.py:224-241``)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def position_table(cache: dict, n: int, dim: int, dtype, device):
    """The [n, dim] sin-cos table in ``dtype`` on ``device``, made once per
    key in ``cache``, outside inference mode (an inference tensor cannot
    take part in a training step)."""
    key = (n, dim, str(device))
    if key not in cache:
        with torch.inference_mode(False):
            cache[key] = torch.from_numpy(sinusoid_position_table(
                n, dim)).to(device=device, dtype=dtype)
    return cache[key]


class _Weight(nn.Module):
    """A bias-free linear's ``weight`` [out, in] (the reference's
    ``attn.qkv``, whose biases live beside it)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_features, in_features), in_features ** -0.5,
            generator))


class VideoMAEAttention(nn.Module):
    """Packed qkv projection with q/v biases only (k bias fixed at zero),
    matching the checkpoint layout (``modeling_finetune.py:75-129``)."""

    def __init__(self, dim: int, num_heads: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.qkv = _Weight(dim, 3 * dim, generator=generator)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = TorchLinear(dim, dim, dtype=dtype, generator=generator,
                                rounding=DENSE)

    def forward(self, x):
        b, n, _ = x.shape
        h = self.num_heads
        dh = self.dim // h
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        # the GEMM sums in fp32 and adds the fp32 bias before its one
        # rounding (JAX's packed qkv: a dot into fp32, then the bias)
        qkv = linear(x, self.qkv.weight, bias, self.dtype,
                     rounding=TORCH_LINEAR).view(b, n, 3, h, dh)
        out = flash_mha_qkv(qkv, sm_scale=dh ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


def recompute(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when a
    gradient is being recorded (``jax.checkpoint``'s counterpart)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ViTBlock(nn.Module):
    """Pre-norm block; ``remat_mlp`` recomputes norm2 + MLP in the backward
    (``tim_tpu/models/backbones/vit.py:142,190``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 0.0, *, dtype: torch.dtype,
                 generator: torch.Generator, remat_mlp: bool = False):
        super().__init__()
        self.dtype, self.remat_mlp = dtype, remat_mlp
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.attn = VideoMAEAttention(dim, num_heads, dtype=dtype,
                                      generator=generator)
        self.norm2 = LayerNorm(dim, eps=EPS)
        self.mlp = GeluMlp(dim, int(dim * mlp_ratio), dtype=dtype,
                           generator=generator)
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x):
        h = self.attn(self.norm1(x).to(self.dtype))
        if self.gamma_1 is not None:
            h = h * self.gamma_1.to(self.dtype)
        x = x + h
        return x + (recompute(self._mlp, x) if self.remat_mlp
                    else self._mlp(x))

    def _mlp(self, x):
        h = self.mlp(self.norm2(x).to(self.dtype))
        if self.gamma_2 is not None:
            h = h * self.gamma_2.to(self.dtype)
        return h


class VideoMAEViT(nn.Module):
    """forward_features path: video [B, T, H, W, 3] (channels-last) ->
    feature [B, D] in the compute dtype (``num_features`` = D).

    ``device``: the CUDA card by default (raises without one); the CPU
    only when asked for. ``generator`` seeds the random init (a fresh
    generator seeded 0 when None); parameters are built on the CPU and
    then moved to ``device``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_frames: int = 16,
                 tubelet_size: int = 2, init_values: float = 0.0,
                 dtype: str = "float32", *, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_mlp: bool = False):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.dtype = _DTYPES[str(dtype)]
        self.embed_dim = self.num_features = embed_dim
        self.depth, self.remat = depth, remat
        self.patch_embed = PatchEmbed3D(
            (tubelet_size, patch_size, patch_size), embed_dim,
            dtype=self.dtype, generator=gen)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, init_values,
                     dtype=self.dtype, generator=gen, remat_mlp=remat_mlp)
            for _ in range(depth))
        self.fc_norm = LayerNorm(embed_dim, eps=EPS)
        self._pos: dict = {}
        self.to(device)
        self.eval()

    def _position_table(self, n: int, device) -> torch.Tensor:
        return position_table(self._pos, n, self.embed_dim, self.dtype,
                              device)

    @inference_unless_training
    def forward(self, video, *, embed_only: bool = False,
                embedded: bool = False):
        """``embed_only``: return the tubelet embedding only, [B, T/2,
        H/ps, W/ps, C], with no position table. ``embedded``: ``video`` is
        already that embedding; skip the conv."""
        b = video.shape[0]
        x = video.to(self.dtype) if embedded else self.patch_embed(video)
        if embed_only:
            return x
        x = x.reshape(b, -1, self.embed_dim)
        x = x + self._position_table(x.shape[1], x.device)[None]
        for block in self.blocks:
            x = recompute(block, x) if self.remat else block(x)
        x = self.fc_norm(x.float().mean(dim=1))
        return x.to(self.dtype)


def videomae_vit_large(dtype: str = "float32", *, device=None,
                       generator: Optional[torch.Generator] = None,
                       **kw) -> VideoMAEViT:
    """ViT-L/16 (width 1024, 24 blocks, 16 heads); ``kw`` overrides any
    other ``VideoMAEViT`` argument (e.g. a reduced ``depth``)."""
    return VideoMAEViT(**{"embed_dim": 1024, "depth": 24, "num_heads": 16,
                          **kw}, dtype=dtype, device=device,
                       generator=generator)
