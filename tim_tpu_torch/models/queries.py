"""Multi-scale interval query pyramid: counterpart of
``tim_tpu/models/queries.py::generate_query_pyramid``.

A copy, not an import: the original module imports jax at top level.
Tests pin the two to equality.
"""

from __future__ import annotations

import numpy as np


def generate_query_pyramid(query_size: float) -> np.ndarray:
    """Intervals of geometrically growing size tiled at 50% overlap over
    [0, 1] (``detection/.../tim.py:144-155``). Returns [Nq, 2] float32.

    Each level: starts = arange(0, 1, size/2), ends = starts + size,
    rounded to 3 decimals; sizes double until >= 1.0.
    """
    levels = []
    size = query_size
    while size < 1.0:
        starts = np.arange(0.0, 1.0, step=size / 2, dtype=np.float32)
        ends = starts + np.float32(size)
        levels.append(np.round(np.stack([starts, ends], axis=-1), 3))
        size *= 2
    return np.concatenate(levels, axis=0).astype(np.float32)
