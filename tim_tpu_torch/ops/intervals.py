"""1-D time-interval (segment) math: counterpart of
``tim_tpu/ops/intervals.py``."""

from __future__ import annotations

import torch


def segment_iou_1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of segments ``a`` and ``b`` with matching shapes
    [..., 2] (start, end). Returns [...]."""
    inter_start = torch.maximum(a[..., 0], b[..., 0])
    inter_end = torch.minimum(a[..., 1], b[..., 1])
    inter = torch.clamp(inter_end - inter_start, min=0.0)
    union = (a[..., 1] - a[..., 0]) + (b[..., 1] - b[..., 0]) - inter
    # inter > 0 implies union > 0, so only 0/0 pairs (two zero-length
    # padding segments) hit the guard: 0, not NaN
    return inter / torch.clamp(union, min=torch.finfo(torch.float32).tiny)


def pairwise_iou_1d(queries: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """IoU between every query [B, Nq, 2] and every target segment
    [B, Na, 2] -> [B, Nq, Na], after shifting all segments by the
    most-negative target start (a no-op for the clamped, window-normalised
    inputs, kept as the reference has it)."""
    q_start = queries[..., 0][:, :, None]     # [B, Nq, 1]
    q_end = queries[..., 1][:, :, None]
    t_start = targets[..., 0][:, None, :]     # [B, 1, Na]
    t_end = targets[..., 1][:, None, :]

    neg_off = torch.abs(torch.clamp(targets[..., 0].amin(-1), max=0.0))
    neg_off = neg_off[:, None, None]
    q_start, q_end = q_start + neg_off, q_end + neg_off
    t_start, t_end = t_start + neg_off, t_end + neg_off

    inter = torch.clamp(torch.minimum(q_end, t_end)
                        - torch.maximum(q_start, t_start), min=0.0)
    union = (t_end - t_start) + (q_end - q_start) - inter
    return inter / union
