"""Dropout masks: counterpart of ``tim_tpu/ops/dropout.py``.

``bits=32`` is a Bernoulli keep mask scaled by 1/(1 - rate) (flax
``nn.Dropout``). ``bits=8`` (``coarse_dropout``) draws one uint8 per
element and keeps it when below ``keep_q = round((1 - rate) * 256)``,
scaled by ``256 / keep_q``: the keep probability is quantized to 1/256
steps and the scale uses the quantized value, so E[mask * scale] = 1
exactly. Masks come from an explicit ``torch.Generator`` on the tensor's
device; the draws are statistically, not bitwise, those of JAX's PRNG.
(The JAX package's ``TIM_TPU_DROPOUT_MUL`` switch gives the same values
as its default form, so it has no counterpart.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _rounded(value: float, x) -> float:
    """``value`` rounded to x's dtype: JAX scales in that dtype."""
    return float(torch.tensor(value, dtype=x.dtype))


def keep_quantized(rate: float) -> int:
    """The uint8 threshold of ``coarse_dropout`` for ``rate``."""
    return int(np.round((1.0 - rate) * 256.0))


def coarse_dropout(x, rate: float, generator: torch.Generator):
    """uint8-mask dropout with an exactly-unbiased quantized keep prob."""
    keep_q = keep_quantized(rate)
    if keep_q >= 256:
        return x
    if keep_q <= 0:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                         device=x.device, generator=generator)
    return torch.where(bits < keep_q, x * _rounded(256.0 / keep_q, x), 0.0)


def dropout(x, rate: float, deterministic: bool, bits: int = 32,
            generator: Optional[torch.Generator] = None):
    """Dropout dispatch: identity when ``deterministic`` or ``rate`` 0;
    ``bits=32`` Bernoulli, ``bits=8`` the uint8-mask variant."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "generator; pass deterministic=True or rate 0 "
                         "for eval")
    if bits == 8:
        return coarse_dropout(x, rate, generator)
    keep = torch.rand(x.shape, device=x.device,
                      generator=generator) < (1.0 - rate)
    return torch.where(keep, x / _rounded(1.0 - rate, x), 0.0)
