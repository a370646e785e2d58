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

Several processes: a rank given ``BatchRows`` in place of a generator
draws each mask for the whole global batch and keeps its own rows, so
that the ranks together draw what one process draws on that batch. On a
model axis a layer adds the other dimensions it holds a slice of
(``BatchRows.along``: heads, FFN columns, tokens): every mask is drawn at
the global shape, in the order of one process, and sliced, so that each
later draw of the layer stays the one process's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


class BatchRows:
    """A generator for one rank's rows ``start:start + b`` of a global
    batch of ``total`` rows: ``draw`` makes the draw of the global shape
    (leading axis ``total``) and keeps those rows; ``slices`` maps any
    other dimension this rank holds a slice of to its (start, global
    size)."""

    def __init__(self, generator: torch.Generator, start: int, total: int,
                 slices: Optional[Dict[int, Tuple[int, int]]] = None):
        self.generator, self.start, self.total = generator, start, total
        self.slices = dict(slices or {})

    def along(self, dim: int, start: int, total: int) -> "BatchRows":
        """The same generator, this rank holding ``start:`` of a global
        ``total`` along ``dim`` too."""
        return BatchRows(self.generator, self.start, self.total,
                         {**self.slices, dim: (start, total)})


def draw(generator, shape: Tuple[int, ...],
         fn: Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]):
    """``fn(shape, generator)``; for ``BatchRows``, this rank's slice of
    ``fn`` at the global shape."""
    if not isinstance(generator, BatchRows):
        return fn(tuple(shape), generator)
    spans = {0: (generator.start, generator.total), **generator.slices}
    full_shape = [spans[d][1] if d in spans else n
                  for d, n in enumerate(shape)]
    full = fn(tuple(full_shape), generator.generator)
    for d, (start, _) in spans.items():
        full = full.narrow(d, start, shape[d])
    return full


def _rounded(value: float, x) -> float:
    """``value`` rounded to x's dtype: JAX scales in that dtype."""
    return float(torch.tensor(value, dtype=x.dtype))


def keep_quantized(rate: float) -> int:
    """The uint8 threshold of ``coarse_dropout`` for ``rate``."""
    return int(np.round((1.0 - rate) * 256.0))


def coarse_dropout(x, rate: float, generator):
    """uint8-mask dropout with an exactly-unbiased quantized keep prob."""
    keep_q = keep_quantized(rate)
    if keep_q >= 256:
        return x
    if keep_q <= 0:
        return torch.zeros_like(x)
    bits = draw(generator, x.shape, lambda s, g: torch.randint(
        0, 256, s, dtype=torch.uint8, device=x.device, generator=g))
    return torch.where(bits < keep_q, x * _rounded(256.0 / keep_q, x), 0.0)


def dropout(x, rate: float, deterministic: bool, bits: int = 32,
            generator=None):
    """Dropout dispatch: identity when ``deterministic`` or ``rate`` 0;
    ``bits=32`` Bernoulli, ``bits=8`` the uint8-mask variant.
    ``generator``: a ``torch.Generator`` on x's device or ``BatchRows``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "generator; pass deterministic=True or rate 0 "
                         "for eval")
    if bits == 8:
        return coarse_dropout(x, rate, generator)
    keep = draw(generator, x.shape, lambda s, g: torch.rand(
        s, device=x.device, generator=g)) < (1.0 - rate)
    return torch.where(keep, x / _rounded(1.0 - rate, x), 0.0)


def layer_generator(seed: int, device,
                    rows: Optional[Tuple[int, int]] = None):
    """A device generator seeded ``seed``; with ``rows`` (this rank's
    first row, the global batch's rows) wrapped in ``BatchRows``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return gen if rows is None else BatchRows(gen, *rows)
