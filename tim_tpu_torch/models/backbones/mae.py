"""VideoMAE masked-autoencoder pretraining model: counterpart of
``tim_tpu/models/backbones/mae.py``.

An asymmetric encoder over the visible tubes, a shallow wide-token decoder
over the whole sequence, per-patch-normalised pixel MSE (Tong et al.,
NeurIPS 2022). The encoder's names are ``VideoMAEViT``'s
(``patch_embed.proj``, ``blocks.{i}``), so a pretrained encoder loads into
the finetune trunk with ``train.checkpoint.shape_matched_merge``. Every
attention core is ``ops.flash_mha`` (kernel 5 on the card, forward and
backward): S = 160 visible tokens in the encoder at mask ratio 0.9 and
the full 1568 in the decoder.

Mask generators (``extract/masking.py``) yield a fixed masked count, so
visible and masked indices stack to [B, Nv] and [B, Nm].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tim_tpu_torch.models.backbones.vit import (
    EPS, ViTBlock, position_table, recompute)
from tim_tpu_torch.models.common import (
    DENSE, LayerNorm, PatchEmbed3D, linear)
from tim_tpu_torch.models.tim import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _trunc_normal(shape, std: float, generator) -> nn.Parameter:
    """flax ``truncated_normal(std)``'s role: N(0, std) cut at 2 std."""
    t = torch.empty(*shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return nn.Parameter(t)


class PretrainVideoMAE(nn.Module):
    """video [B, T, H, W, 3], visible_idx [B, Nv], masked_idx [B, Nm] (flat
    tube indices) -> reconstructions of the masked tubes
    [B, Nm, tubelet * patch^2 * 3] in the compute dtype.

    ``device``: the CUDA card by default (raises without one); the CPU
    only when asked for. ``generator`` seeds the random init.
    ``remat_mlp`` / ``remat`` as in ``VideoMAEViT``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, decoder_dim: int = 512,
                 decoder_depth: int = 12, decoder_heads: int = 8,
                 num_frames: int = 16, tubelet_size: int = 2,
                 dtype: str = "float32", *, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, remat_mlp: bool = False):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.dtype = _DTYPES[str(dtype)]
        self.img_size, self.patch_size = img_size, patch_size
        self.num_frames, self.tubelet_size = num_frames, tubelet_size
        self.embed_dim, self.decoder_dim = embed_dim, decoder_dim
        self.depth, self.remat = depth, remat
        self.patch_embed = PatchEmbed3D(
            (tubelet_size, patch_size, patch_size), embed_dim,
            dtype=self.dtype, generator=gen)

        def blocks(dim, heads, n):
            return nn.ModuleList(
                ViTBlock(dim, heads, mlp_ratio, dtype=self.dtype,
                         generator=gen, remat_mlp=remat_mlp)
                for _ in range(n))

        self.blocks = blocks(embed_dim, num_heads, depth)
        self.encoder_norm = LayerNorm(embed_dim, eps=EPS)
        self.encoder_to_decoder = nn.Module()
        self.encoder_to_decoder.weight = _trunc_normal(
            (decoder_dim, embed_dim), 0.02, gen)
        self.mask_token = _trunc_normal((1, 1, decoder_dim), 0.02, gen)
        self.decoder_blocks = blocks(decoder_dim, decoder_heads,
                                     decoder_depth)
        self.decoder_norm = LayerNorm(decoder_dim, eps=EPS)
        out = tubelet_size * patch_size ** 2 * 3
        self.decoder_head = nn.Module()
        self.decoder_head.weight = _trunc_normal((out, decoder_dim), 0.02,
                                                 gen)
        self.decoder_head.bias = nn.Parameter(torch.zeros(out))
        self._pos: dict = {}
        self.to(device)

    @property
    def grid(self):
        s = self.img_size // self.patch_size
        return (self.num_frames // self.tubelet_size, s, s)

    def _run(self, blocks, x):
        for block in blocks:
            x = recompute(block, x) if self.remat else block(x)
        return x

    def forward(self, video, visible_idx, masked_idx):
        b, dt = video.shape[0], self.dtype
        visible_idx, masked_idx = visible_idx.long(), masked_idx.long()
        x = self.patch_embed(video).reshape(b, -1, self.embed_dim)
        n = x.shape[1]
        x = x + position_table(self._pos, n, self.embed_dim, dt,
                               x.device)[None]
        xv = torch.gather(x, 1, visible_idx[..., None].expand(
            -1, -1, self.embed_dim))
        xv = self._run(self.blocks, xv)
        xv = self.encoder_norm(xv).to(dt)
        xv = linear(xv, self.encoder_to_decoder.weight, None, dt,
                    rounding=DENSE)
        dpos = position_table(self._pos, n, self.decoder_dim, dt, x.device)
        d = torch.cat([xv + dpos[visible_idx],
                       self.mask_token.to(dt) + dpos[masked_idx]], dim=1)
        d = self._run(self.decoder_blocks, d)
        d = self.decoder_norm(d).to(dt)
        return linear(d[:, -masked_idx.shape[1]:], self.decoder_head.weight,
                      self.decoder_head.bias, dt, rounding=DENSE)


def patchify(video, tubelet: int, patch: int):
    """[B, T, H, W, 3] -> [B, N, tubelet*patch*patch, 3], tubes ordered
    t-major then row-major spatially (the patch embed's order)."""
    b, t, h, w, c = video.shape
    tt, hh, ww = t // tubelet, h // patch, w // patch
    x = video.reshape(b, tt, tubelet, hh, patch, ww, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, tt * hh * ww, tubelet * patch * patch, c)


def pretrain_targets(video, masked_idx, tubelet: int, patch: int,
                     normalize: bool = True):
    """Per-patch-normalised pixel targets at the masked tubes (mean and
    unbiased std over the positions within each tube, per channel)."""
    patches = patchify(video.float(), tubelet, patch)
    if normalize:
        mean = patches.mean(dim=-2, keepdim=True)
        k = patches.shape[-2]
        var = ((patches - mean) ** 2).sum(dim=-2, keepdim=True) / (k - 1)
        patches = (patches - mean) / (torch.sqrt(var) + 1e-6)
    b, n = patches.shape[:2]
    flat = patches.reshape(b, n, -1)
    return torch.gather(flat, 1, masked_idx.long()[..., None].expand(
        -1, -1, flat.shape[-1]))


def pretrain_loss(pred, video, masked_idx, tubelet: int, patch: int,
                  normalize: bool = True):
    """MSE over masked-tube reconstructions."""
    labels = pretrain_targets(video, masked_idx, tubelet, patch, normalize)
    return torch.mean((pred.float() - labels) ** 2)
