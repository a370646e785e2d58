"""Accuracy metrics (numpy): a copy of ``tim_tpu/evals/metrics.py``,
matching ``recognition/.../utils/metrics.py:4-56``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def topk_accuracy(
    scores: np.ndarray, labels: np.ndarray, topk: Sequence[int] = (1, 5)
) -> Tuple[float, ...]:
    """scores [N, C], labels [N] -> accuracy@k percentages."""
    max_k = max(topk)
    n = len(labels)
    if n == 0:
        return tuple(0.0 for _ in topk)
    top = np.argsort(-scores, axis=1, kind="stable")[:, :max_k]
    correct = top == labels[:, None]
    return tuple(
        float(correct[:, :k].any(axis=1).sum() * 100.0 / n) for k in topk)


def multitask_accuracy(
    scores: Sequence[np.ndarray], labels: Sequence[np.ndarray],
    topk: Sequence[int] = (1, 5),
) -> Tuple[float, ...]:
    """All tasks correct simultaneously within top-k (verb AND noun)."""
    max_k = max(topk)
    n = len(labels[0])
    if n == 0:
        return tuple(0.0 for _ in topk)
    # all_correct[k, i] counts tasks where label i is within top-(k+1)
    all_correct = np.zeros((max_k, n), np.int32)
    for s, l in zip(scores, labels):
        top = np.argsort(-s, axis=1, kind="stable")[:, :max_k]
        correct = (top == l[:, None]).T  # [max_k, N]
        all_correct += correct
    task_count = len(scores)
    out = []
    for k in topk:
        hits = all_correct[:k].sum(axis=0) >= task_count
        out.append(float(hits.sum() * 100.0 / n))
    return tuple(out)
