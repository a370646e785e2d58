"""Omnivore SwinTransformer3D: counterpart of
``tim_tpu/models/backbones/swin3d.py``.

Conv3D patch embedding, stages of (shifted-)3D-window attention with a
relative-position bias, 2x2 spatial patch merging between stages, a final
LayerNorm and a spatio-temporal mean pool. The Omnivore Swin-B EPIC trunk
(``omnivore_swinB_epic``): patch (2, 4, 4), dim 128, depths (2, 2, 18, 2),
heads (4, 8, 16, 32), window (16, 7, 7), 1024-d features.

Parameter names are the reference trunk's, the keys that
``swin3d.params_from_torch`` reads: ``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.downsample.{norm, reduction}`` and ``norm``.

The window-attention core is ``ops.window_attention`` (kernel 4 on the
card, forward and backward): it takes the relative-position bias
[H, N, N] and, in shifted blocks, the [nW, N] region ids whose
differences are the -100 shift mask; the bias gradient flows back through
the index gather into ``relative_position_bias_table``. The model is
built in eval mode, where its forward runs under ``torch.inference_mode``
(feature extraction); after ``.train()`` and with grad enabled it records
autograd.
Reference quirks kept: effective windows clamp to the input extent and
clamped dims do not shift; the bias index is row-sliced ``[:N, :N]`` when
the window is clamped; the shift mask keeps the ``slice(-0, None)``
behaviour; patch merging pads odd H/W.

``quantized=True`` is the int8 serving mode (no reference counterpart,
as in JAX): ``attn.qkv``, ``attn.proj``, ``mlp.fc1`` and ``mlp.fc2`` are
``Int8Dense`` (load ``ops.quant.quantize_backbone_state_dict`` weights),
each with its output in the compute dtype after the fp32 bias. Without
calibrated scales every int8 layer quantizes its activations per row;
``act_scales`` (the JAX package's (path, scale) tuple, paths such as
``layer0_block1/attn/qkv``; ``set_act_scales``, ``int8_layers``) makes
them static.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tim_tpu_torch.models.common import (
    DENSE, GeluMlp, Int8Dense, Int8GeluMlp, LayerNorm, PatchEmbed3D,
    TorchLinear, inference_unless_training, set_act_scales)
from tim_tpu_torch.models.tim import resolve_device
from tim_tpu_torch.ops.window_attention import window_attention_qkv

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def effective_window(x_size, window_size, shift_size):
    """Clamp window dims to input extent; clamped dims don't shift."""
    win = list(window_size)
    shift = list(shift_size)
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            win[i] = s
            shift[i] = 0
    return tuple(win), tuple(shift)


@lru_cache(maxsize=None)
def relative_position_index(window_size: Tuple[int, int, int]) -> np.ndarray:
    """[N, N] indices into the (2Wd-1)(2Wh-1)(2Ww-1) bias table."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(
        np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_region_ids(dims, window_size, shift_size) -> np.ndarray:
    """[nW, N] int32 region id of every token of every window, the labels
    of ``compute_mask`` (swin_transformer.py:468-494). Two tokens of a
    window attend without the -100 mask exactly when their ids agree."""
    dp, hp, wp = dims
    img = np.zeros((dp, hp, wp))
    cnt = 0
    # NOTE: slice(-0, None) == the whole dim: for shift-0 dims the last
    # slice overwrites everything, leaving no boundary along that dim, as
    # the reference does (swin_transformer.py:471-487).
    for d in (slice(None, -window_size[0]),
              slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(None, -window_size[1]),
                  slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(None, -window_size[2]),
                      slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    windows = _partition_np(img[None, ..., None], window_size)[..., 0]
    return windows.astype(np.int32)


def shift_attention_mask(dims, window_size, shift_size) -> np.ndarray:
    """[nW, N, N] additive mask (-100 across shift boundaries), matching
    ``compute_mask`` (swin_transformer.py:468-494)."""
    windows = shift_region_ids(dims, window_size, shift_size)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _partition_np(x, window):
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // window[0], window[0], h // window[1], window[1],
                  w // window[2], window[2], c)
    return x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, window[0] * window[1] * window[2], c)


def window_partition(x, window):
    """[B, D, H, W, C] -> [B*nW, N, C] (window index fastest within a
    clip)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // window[0], window[0], h // window[1], window[1],
                  w // window[2], window[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, window[0] * window[1] * window[2], c)


def window_reverse(windows, window, b, d, h, w):
    c = windows.shape[-1]
    x = windows.reshape(b, d // window[0], h // window[1], w // window[2],
                        window[0], window[1], window[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def _on_device(cache: dict, key, make, device):
    """A numpy constant as a tensor on ``device``, made once per key and
    device in the caller's ``cache``, outside inference mode (an inference
    tensor cannot be saved for a backward, and ``index_select`` saves its
    index)."""
    full = (key, str(device))
    if full not in cache:
        with torch.inference_mode(False):
            cache[full] = torch.from_numpy(np.ascontiguousarray(make())).to(
                device)
    return cache[full]


def _init_normal(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


class WindowAttention3D(nn.Module):
    """Packed ``qkv`` and ``proj`` linears around the window-attention
    core, with the ``relative_position_bias_table`` of the configured
    (``full_window``) size."""

    def __init__(self, dim: int, full_window: Tuple[int, int, int],
                 num_heads: int, *, dtype: torch.dtype,
                 generator: torch.Generator, quantized: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.full_window = tuple(full_window)
        wd, wh, ww = self.full_window
        self.relative_position_bias_table = _init_normal(
            ((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads), 0.02,
            generator)
        if quantized:
            self.qkv = Int8Dense(dim, 3 * dim, dtype=dtype)
            self.proj = Int8Dense(dim, dim, dtype=dtype)
        else:
            self.qkv = TorchLinear(dim, 3 * dim, dtype=dtype,
                                   generator=generator, rounding=DENSE)
            self.proj = TorchLinear(dim, dim, dtype=dtype,
                                    generator=generator, rounding=DENSE)
        self._consts: dict = {}

    def forward(self, x, region_ids: Optional[torch.Tensor]):
        """x: [B*nW, N, C]; region_ids: [nW, N] int32 or None."""
        bn, n, c = x.shape
        h = self.num_heads
        dh = c // h
        qkv = self.qkv(x).view(bn, n, 3, h, dh)
        idx = _on_device(self._consts, n, lambda: (
            relative_position_index(self.full_window)[:n, :n]
            .reshape(-1).astype(np.int64)), x.device)
        # gathered straight into the kernel's [H, N, N] layout
        bias = torch.index_select(
            self.relative_position_bias_table.t().contiguous(), 1,
            idx).view(h, n, n).float()
        out = window_attention_qkv(qkv, bias, region_ids, sm_scale=dh ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(bn, n, c))


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int], shift: bool, *,
                 mlp_ratio: float, dtype: torch.dtype,
                 generator: torch.Generator, quantized: bool = False):
        super().__init__()
        self.window_size, self.shift, self.dtype = (
            tuple(window_size), shift, dtype)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, window_size, num_heads,
                                      dtype=dtype, generator=generator,
                                      quantized=quantized)
        self.norm2 = LayerNorm(dim)
        self.mlp = (Int8GeluMlp(dim, int(dim * mlp_ratio), dtype=dtype)
                    if quantized else
                    GeluMlp(dim, int(dim * mlp_ratio), dtype=dtype,
                            generator=generator))
        self._consts: dict = {}

    def forward(self, x):
        b, d, h, w, c = x.shape
        shift_cfg = (tuple(i // 2 for i in self.window_size) if self.shift
                     else (0, 0, 0))
        window, shift = effective_window((d, h, w), self.window_size,
                                         shift_cfg)
        shortcut = x
        x = self.norm1(x).to(self.dtype)
        pad_d, pad_h, pad_w = (-d) % window[0], (-h) % window[1], \
            (-w) % window[2]
        if pad_d or pad_h or pad_w:
            x = nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        dp, hp, wp = d + pad_d, h + pad_h, w + pad_w

        shifted = any(s > 0 for s in shift)
        region_ids = None
        if shifted:
            x = torch.roll(x, (-shift[0], -shift[1], -shift[2]),
                           dims=(1, 2, 3))
            region_ids = _on_device(
                self._consts, ((dp, hp, wp), window, shift),
                lambda: shift_region_ids((dp, hp, wp), window, shift),
                x.device)
        attn = self.attn(window_partition(x, window), region_ids)
        x = window_reverse(attn, window, b, dp, hp, wp)
        if shifted:
            x = torch.roll(x, shift, dims=(1, 2, 3))
        if pad_d or pad_h or pad_w:
            x = x[:, :d, :h, :w]
        x = shortcut + x
        return x + self.mlp(self.norm2(x).to(self.dtype))


class PatchMerging(nn.Module):
    """2x2 spatial concat -> LayerNorm -> Linear(4C -> 2C), no bias
    (``swin_transformer.py:426-463``)."""

    def __init__(self, dim: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim)
        self.reduction = TorchLinear(4 * dim, 2 * dim, dtype=dtype,
                                     generator=generator, rounding=DENSE,
                                     use_bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if h % 2 or w % 2:
            x = nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x).to(self.dtype))


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer3D(nn.Module):
    """Video [B, D, H, W, 3] (channels-last) -> feature [B, 8 * embed_dim]
    (``num_features``) in the compute dtype.

    ``device``: the CUDA card by default (raises without one); the CPU
    only when asked for. ``generator`` seeds the random init (a fresh
    generator seeded 0 when None); parameters are built on the CPU and
    then moved to ``device``. Released trunks load over the init
    (``convert.load_backbone_state``). ``quantized`` / ``act_scales``:
    the int8 serving mode (module docstring)."""

    def __init__(self, patch_size=(2, 4, 4), embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size=(16, 7, 7), mlp_ratio: float = 4.0,
                 patch_norm: bool = True, dtype: str = "float32", *,
                 device=None, generator: Optional[torch.Generator] = None,
                 quantized: bool = False, act_scales: tuple = ()):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.dtype = _DTYPES[str(dtype)]
        self.depths = tuple(depths)
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim,
                                        dtype=self.dtype, generator=gen,
                                        norm=patch_norm)
        stages = []
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = int(embed_dim * 2 ** i)
            blocks = [SwinBlock3D(dim, heads, window_size, shift=(j % 2 == 1),
                                  mlp_ratio=mlp_ratio, dtype=self.dtype,
                                  generator=gen, quantized=quantized)
                      for j in range(depth)]
            down = (PatchMerging(dim, dtype=self.dtype, generator=gen)
                    if i < len(depths) - 1 else None)
            stages.append(SwinStage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.num_features = int(embed_dim * 2 ** (len(depths) - 1))
        self.norm = LayerNorm(self.num_features)
        if quantized:
            self.set_act_scales(act_scales)
        self.to(device)
        self.eval()

    def int8_layers(self) -> Dict[str, Int8Dense]:
        """The int8 linears (empty unless quantized) by the JAX package's
        param path: ``layer{i}_block{j}/attn/qkv``, ``.../attn/proj``,
        ``.../fc1``, ``.../fc2``."""
        out = {}
        for i, stage in enumerate(self.layers):
            for j, block in enumerate(stage.blocks):
                for path, m in (("attn/qkv", block.attn.qkv),
                                ("attn/proj", block.attn.proj),
                                ("fc1", block.mlp.fc1),
                                ("fc2", block.mlp.fc2)):
                    if isinstance(m, Int8Dense):
                        out[f"layer{i}_block{j}/{path}"] = m
        return out

    def set_act_scales(self, act_scales) -> None:
        """Static activation scales from a (path, scale) tuple; a layer it
        misses stays dynamic (with a warning when the tuple is not
        empty)."""
        set_act_scales(self.int8_layers(), act_scales)

    @inference_unless_training
    def forward(self, video, pool: bool = True, *, embed_only: bool = False,
                embedded: bool = False):
        """``embed_only``: return the patch embedding (conv + patch norm)
        only, [B, T/pt, H/ph, W/pw, C]. ``embedded``: ``video`` is already
        that embedding; skip the conv."""
        if embedded:
            x = video.to(self.dtype)
        else:
            x = self.patch_embed(video)
        if embed_only:
            return x
        for stage in self.layers:
            for block in stage.blocks:
                x = block(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        x = self.norm(x)
        if pool:
            return x.mean(dim=(1, 2, 3)).to(self.dtype)
        return x.to(self.dtype)


def omnivore_swinB_epic(dtype: str = "float32", *, device=None,
                        generator: Optional[torch.Generator] = None,
                        quantized: bool = False,
                        **kw) -> SwinTransformer3D:
    """The EPIC-KITCHENS Omnivore trunk config
    (``omnivore_model.py:136-162``); ``quantized``: the int8 serving
    mode, its weights from ``ops.quant.quantize_backbone_state_dict``."""
    return SwinTransformer3D(dtype=dtype, device=device, generator=generator,
                             quantized=quantized, **kw)
