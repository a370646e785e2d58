"""Sliding-window feature selection: a copy of
``tim_tpu/data/windows.py::window_feat_indices`` (tests pin the two to
equality)."""

from __future__ import annotations

import numpy as np


def window_feat_indices(
    feat_times: np.ndarray,
    window_start: float,
    window_stop: float,
    feat_stride: int,
    num_feats: int,
) -> np.ndarray:
    """Pick ``num_feats`` feature rows covering the window: nearest feature
    start to the window start, nearest feature end to the window stop,
    strided, clipped, and right-padded by repeating the final index."""
    start_time = max(0.0, window_start)
    input_start = int(np.abs(feat_times[:, 0] - start_time).argmin())
    input_end = int(np.abs(feat_times[:, 1] - window_stop).argmin())

    idx = np.arange(input_start, input_end, feat_stride)
    if idx.size == 0:
        idx = np.asarray([input_start])
    idx = np.clip(idx, 0, len(feat_times) - 1)
    if idx.size < num_feats:
        idx = np.concatenate(
            [idx, np.full(num_feats - idx.size, idx[-1], idx.dtype)])
    return idx[:num_feats].astype(np.int64)
