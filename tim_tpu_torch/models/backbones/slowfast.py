"""Auditory SlowFast (the audio feature backbone): counterpart of
``tim_tpu/models/backbones/slowfast.py``.

A two-pathway audio ResNet over log-mel spectrograms: a Slow pathway
(time subsampled by ``alpha``) and a Fast one (``1 / beta_inv`` of the
channels), each a 2-D ResNet-50 whose convolutions act on (time,
frequency), with Fast -> Slow fusion convolutions after the stem and
stages 2-4; the head averages both pathways over (time, frequency) and
concatenates them into the 2304-d feature TIM takes. EPIC-Sounds
configuration: R50, alpha 4, beta_inv 8, fusion ratio 2, fusion kernel 7.

Layout is the reference's, NCHW: slow [B, 1, T / alpha, F] and fast
[B, 1, T, F] (``pack_pathways`` makes both from one [B, 1, T, F]
spectrogram); the JAX package runs NHWC. Parameter names are the
reference checkpoint's, the keys ``slowfast.params_from_torch`` reads:
``s1.pathway{p}_stem.{conv, bn}``, ``s{1..4}_fuse.{conv_f2s, bn}``,
``s{2..5}.pathway{p}_res{i}.{branch1, branch1_bn, branch2.{a, a_bn, b,
b_bn, c, c_bn}}`` and ``head.projection``; the BatchNorms keep
``num_batches_tracked`` as torch's do, so a reference state dict loads
strictly.

The model runs in fp32 with cuDNN's TF32 off (``models.common.no_tf32``:
it is on by default for convolutions). It is built in eval mode, where
BatchNorm uses its running statistics, the forward runs under
``torch.inference_mode`` and the logits come out softmaxed, as the
reference's eval head does; ``.train()`` makes it record autograd, use
batch statistics, drop out the pooled feature and return raw logits.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tim_tpu_torch.models.common import inference_unless_training, no_tf32
from tim_tpu_torch.models.tim import resolve_device

STAGE_DEPTHS_R50 = (3, 4, 6, 3)
# conv1/res2..res5 temporal kernels per pathway, as the reference sets them
TEMPORAL_KERNELS = {"slow": (1, 1, 1, 3, 3), "fast": (5, 3, 3, 3, 3)}
BN_EPS = 1e-5


def _conv(dim_in: int, dim_out: int, kernel, stride, padding,
          generator: torch.Generator, dilation=(1, 1)) -> nn.Conv2d:
    """A bias-free conv; ``padding`` is given before dilation and scales
    with it, as the reference pads dilated convs (resnet_helper.py:193-202).
    Init: the reference's ``c2_msra_fill``, a normal of std
    sqrt(2 / fan_out)."""
    pad = tuple(p * d for p, d in zip(padding, dilation))
    conv = nn.Conv2d(dim_in, dim_out, tuple(kernel), stride=tuple(stride),
                     padding=pad, dilation=tuple(dilation), bias=False)
    fan_out = dim_out * math.prod(kernel)
    with torch.no_grad():
        conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                            generator=generator)
    return conv


def _bn(dim: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(dim, eps=BN_EPS)


class Stem(nn.Module):
    """Conv([t, 7], stride [2, 2]) -> BN -> ReLU -> MaxPool 3x3/2, padded
    by 1 (``stem_helper.py:100-174``)."""

    def __init__(self, dim_out: int, temp_kernel: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = _conv(1, dim_out, (temp_kernel, 7), (2, 2),
                          (temp_kernel // 2, 3), generator)
        self.bn = _bn(dim_out)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class Bottleneck(nn.Module):
    """Tx1 -> 1x3 (frequency stride and dilation) -> 1x1, BN after each
    (``resnet_helper.py:107-237``)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel: int, stride: int, dilation: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.a = _conv(dim_in, dim_inner, (temp_kernel, 1), (1, 1),
                       (temp_kernel // 2, 0), generator)
        self.a_bn = _bn(dim_inner)
        self.b = _conv(dim_inner, dim_inner, (1, 3), (1, stride), (0, 1),
                       generator, dilation=(1, dilation))
        self.b_bn = _bn(dim_inner)
        self.c = _conv(dim_inner, dim_out, (1, 1), (1, 1), (0, 0), generator)
        self.c_bn = _bn(dim_out)

    def forward(self, x):
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class ResBlock(nn.Module):
    """``branch2`` (the bottleneck) plus the input, through ``branch1``
    (a strided 1x1 conv and BN) where the width or the stride changes."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel: int, stride: int, dilation: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.branch2 = Bottleneck(dim_in, dim_out, dim_inner, temp_kernel,
                                  stride, dilation, generator=generator)
        if dim_in != dim_out or stride != 1:
            self.branch1 = _conv(dim_in, dim_out, (1, 1), (1, stride),
                                 (0, 0), generator)
            self.branch1_bn = _bn(dim_out)
        else:
            self.branch1 = self.branch1_bn = None

    def forward(self, x):
        h = self.branch2(x)
        if self.branch1 is not None:
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + h)


class FuseFastToSlow(nn.Module):
    """A temporal conv over Fast, strided by ``alpha`` in time,
    concatenated onto Slow's channels (the reference's
    ``FuseFastToSlow``)."""

    def __init__(self, dim_fast: int, ratio: int, kernel: int, alpha: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv_f2s = _conv(dim_fast, dim_fast * ratio, (kernel, 1),
                              (alpha, 1), (kernel // 2, 0), generator)
        self.bn = _bn(dim_fast * ratio)

    def forward(self, slow, fast):
        f = F.relu(self.bn(self.conv_f2s(fast)))
        return torch.cat([slow, f], dim=1), fast


class AuditorySlowFast(nn.Module):
    """Two-pathway audio ResNet: (slow [B, 1, T / alpha, F], fast [B, 1, T,
    F]) -> (logits [B, num_classes], feature [B, 32 w + 32 w / beta_inv]):
    2304-d at the EPIC-Sounds defaults.

    ``device``: the CUDA card by default (raises without one); the CPU only
    when asked for. ``generator`` seeds the random init (a fresh generator
    seeded 0 when None): the reference's (convs ``c2_msra_fill``, BN
    weight 1 and bias 0, the projection a normal of std 0.01 and bias 0);
    parameters are built on the CPU and then moved to ``device``."""

    def __init__(self, num_classes: int = 44, width: int = 64, alpha: int = 4,
                 beta_inv: int = 8, fusion_ratio: int = 2,
                 fusion_kernel: int = 7,
                 depths: Sequence[int] = STAGE_DEPTHS_R50,
                 freq_strides: Sequence[int] = (1, 2, 2, 2),
                 freq_dilations: Sequence[int] = (1, 1, 1, 1),
                 dropout_rate: float = 0.5, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.alpha = alpha
        w, binv = width, beta_inv

        def fuse(dim_fast):
            return FuseFastToSlow(dim_fast, fusion_ratio, fusion_kernel,
                                  alpha, generator=gen)

        # stages hold both pathways under the reference's names:
        # s1.pathway{p}_stem, s{2..5}.pathway{p}_res{i}
        self.s1 = nn.Module()
        self.s1.pathway0_stem = Stem(w, TEMPORAL_KERNELS["slow"][0],
                                     generator=gen)
        self.s1.pathway1_stem = Stem(w // binv, TEMPORAL_KERNELS["fast"][0],
                                     generator=gen)
        self.s1_fuse = fuse(w // binv)
        slow_in = w + w // binv * fusion_ratio
        fast_in = w // binv
        stage_dims = [w * 4, w * 8, w * 16, w * 32]
        inner_dims = [w, w * 2, w * 4, w * 8]
        for s, (dim, inner, depth) in enumerate(
                zip(stage_dims, inner_dims, depths)):
            stage = nn.Module()
            for p, (d_in, d_out, d_inner, t) in enumerate((
                    (slow_in, dim, inner, TEMPORAL_KERNELS["slow"][s + 1]),
                    (fast_in, dim // binv, inner // binv,
                     TEMPORAL_KERNELS["fast"][s + 1]))):
                for i in range(depth):
                    setattr(stage, f"pathway{p}_res{i}", ResBlock(
                        d_in if i == 0 else d_out, d_out, d_inner, t,
                        freq_strides[s] if i == 0 else 1, freq_dilations[s],
                        generator=gen))
            setattr(self, f"s{s + 2}", stage)
            slow_in, fast_in = dim, dim // binv
            if s < 3:
                setattr(self, f"s{s + 2}_fuse", fuse(fast_in))
                slow_in += fast_in * fusion_ratio
        self.depths = tuple(depths)
        self.num_features = slow_in + fast_in
        self.dropout = nn.Dropout(dropout_rate)
        self.head = nn.Module()
        self.head.projection = nn.Linear(self.num_features, num_classes)
        with torch.no_grad():
            self.head.projection.weight.normal_(0.0, 0.01, generator=gen)
            self.head.projection.bias.zero_()
        self.to(device)
        self.eval()

    @inference_unless_training
    def forward(self, slow, fast):
        with no_tf32():
            slow = self.s1.pathway0_stem(slow.float())
            fast = self.s1.pathway1_stem(fast.float())
            slow, fast = self.s1_fuse(slow, fast)
            for s, depth in enumerate(self.depths):
                stage = getattr(self, f"s{s + 2}")
                for i in range(depth):
                    slow = getattr(stage, f"pathway0_res{i}")(slow)
                    fast = getattr(stage, f"pathway1_res{i}")(fast)
                if s < 3:
                    slow, fast = getattr(self, f"s{s + 2}_fuse")(slow, fast)
        # head (``head_helper.py:76-117``): the mean over (T, F) of both
        # pathways, concatenated; the reference drops out the pooled
        # features feeding both the projection and the returned feature
        feature = torch.cat([slow.mean(dim=(2, 3)), fast.mean(dim=(2, 3))],
                            dim=1)
        feature = self.dropout(feature)
        logits = self.head.projection(feature)
        if not self.training:
            logits = torch.softmax(logits, dim=-1)
        return logits, feature


def pack_pathways(spectrogram: torch.Tensor, alpha: int = 4):
    """[B, 1, T, F] -> (slow [B, 1, T // alpha, F], fast): the temporal
    subsampling of the reference's ``utils.pack_pathway_output``
    (``torch.index_select`` at ``linspace(0, T - 1, T // alpha)``)."""
    t = spectrogram.shape[2]
    idx = torch.linspace(0, t - 1, t // alpha).long().to(spectrogram.device)
    return torch.index_select(spectrogram, 2, idx), spectrogram
