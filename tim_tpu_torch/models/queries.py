"""Multi-scale interval query pyramid and IoU-based query labelling:
counterpart of ``tim_tpu/models/queries.py``.

``generate_query_pyramid`` is a copy of the numpy original (tests pin the
two to equality); sampling and labelling are torch functions. Sampling
draws its permutation from an explicit CPU ``torch.Generator``, so the
card and the CPU draw the same queries.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tim_tpu_torch.ops.intervals import pairwise_iou_1d
from tim_tpu_torch.ops.losses import smooth_positive_labels


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


def sample_train_queries(generator: torch.Generator, train_pool: torch.Tensor,
                         num_queries: int) -> torch.Tensor:
    """A random subsample [num_queries, 2] of the train pool, shared
    across the batch: a permutation of the pool from ``generator`` (a CPU
    generator), cut to ``num_queries``."""
    idx = torch.randperm(train_pool.shape[0], generator=generator)
    return train_pool[idx[:num_queries].to(train_pool.device)]


def label_queries(queries: torch.Tensor, gt_segments: torch.Tensor,
                  gt_labels: torch.Tensor, iou_threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign each query [B, Nq, 2] its max-IoU GT segment of
    ``gt_segments`` [B, Na, 2] (zero-padded; labels [B, Na, L] -1-padded);
    negatives (IoU < thr) get inf regression targets and -1 labels.

    Returns (query_targets [B, Nq, 2], query_labels [B, Nq, L],
    query_ious [B, Nq])."""
    ious = pairwise_iou_1d(queries, gt_segments)             # [B, Nq, Na]
    # zero-padded GT rows have IoU 0, so argmax takes padding only when
    # every IoU is 0, and the query is then negative anyway
    best = ious.argmax(-1)                                   # first max
    best_iou = torch.take_along_dim(ious, best[..., None], dim=-1)[..., 0]
    targets = torch.take_along_dim(gt_segments, best[..., None], dim=1)
    labels = torch.take_along_dim(gt_labels, best[..., None], dim=1)
    negative = (best_iou < iou_threshold)[..., None]
    targets = torch.where(negative, torch.inf, targets)
    labels = torch.where(negative, -1, labels)
    return targets, labels, best_iou


def smooth_detection_labels(labels, visual_classes, audio_classes,
                            smoothing: float, modality: str):
    """Int labels [..., L] -> the smoothed one-hot focal targets: for
    ``visual`` a (verb, noun, action) tuple (verb and noun None unless
    L is 3), else the audio targets."""
    if modality == "visual":
        out = []
        if labels.shape[-1] == 3:
            out.append(smooth_positive_labels(
                labels[..., 0], visual_classes[0], smoothing))
            out.append(smooth_positive_labels(
                labels[..., 1], visual_classes[1], smoothing))
        else:
            out.extend([None, None])
        out.append(smooth_positive_labels(
            labels[..., -1], visual_classes[-1], smoothing))
        return tuple(out)
    return smooth_positive_labels(labels[..., -1], audio_classes, smoothing)
