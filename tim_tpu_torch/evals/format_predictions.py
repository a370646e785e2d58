"""Dense prediction dump -> thresholded candidates -> per-video Soft-NMS:
a copy of the serving part of ``tim_tpu/evals/format_predictions.py``
(threshold at the score, expand multi-label proposals, multi-class
Soft-NMS per video). The mAP evaluator is not ported. Tests pin these to
the originals."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from tim_tpu_torch.evals.nms import batched_nms


def _build_candidates(video_ids, proposals, row_fn, score_threshold):
    """Candidate collection: ``row_fn(i)`` returns the (scores_row,
    labels_row) pair to threshold for valid-length proposal ``i``."""
    proposals = np.round(np.asarray(proposals, np.float64), 3)
    out: Dict[str, Dict[str, List]] = {}
    valid_len = proposals[:, 1] - proposals[:, 0] > 0.0
    for i in np.flatnonzero(valid_len):
        scores_row, labels_row = row_fn(i)
        sel = np.flatnonzero(scores_row > score_threshold)
        if sel.size == 0:
            continue
        vid = str(video_ids[i])
        entry = out.setdefault(vid, {"segments": [], "scores": [],
                                     "labels": []})
        entry["segments"].extend([proposals[i]] * sel.size)
        entry["scores"].extend(scores_row[sel].tolist())
        entry["labels"].extend(labels_row[sel].tolist())
    return {
        vid: {
            "segments": np.asarray(e["segments"], np.float32).reshape(-1, 2),
            "scores": np.asarray(e["scores"], np.float32),
            "labels": np.asarray(e["labels"], np.int64),
        } for vid, e in out.items()
    }


def threshold_predictions(
    video_ids: np.ndarray,        # [N] str
    proposals: np.ndarray,        # [N, 2] video-time segments
    scores: np.ndarray,           # [N, C]
    score_threshold: float = 0.03,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-video candidate lists: every (proposal, class) pair whose score
    clears the threshold. Zero/negative-length proposals are dropped."""
    labels = np.arange(np.asarray(scores).shape[-1])
    return _build_candidates(video_ids, proposals,
                             lambda i: (scores[i], labels),
                             score_threshold)


def threshold_predictions_topk(
    video_ids: np.ndarray,        # [N] str
    proposals: np.ndarray,        # [N, 2] video-time segments
    topk_values: np.ndarray,      # [N, k] sorted descending
    topk_classes: np.ndarray,     # [N, k] int
    score_threshold: float = 0.03,
    num_classes: Optional[int] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """``threshold_predictions`` over a top-k dump instead of the dense
    [N, C] matrix. Identical candidates whenever every class above the
    threshold fits in k; rows where even the k-th score clears the
    threshold may be truncated, and are counted in a warning (skipped when
    ``num_classes`` shows k covers every class)."""
    topk_values = np.asarray(topk_values)
    topk_classes = np.asarray(topk_classes)
    k = topk_values.shape[-1]
    if num_classes is None or k < num_classes:
        # the 3-decimal rounding of _build_candidates, so that the warned
        # counts match the rows kept
        props = np.round(np.asarray(proposals, np.float64), 3)
        valid_len = props[:, 1] - props[:, 0] > 0.0
        saturated = int(
            (topk_values[valid_len, -1] > score_threshold).sum())
        if saturated:
            logging.getLogger(__name__).warning(
                "top-k dump may truncate %d / %d proposals (k-th score "
                "above the %.3g threshold) — raise top_k", saturated,
                int(valid_len.sum()), score_threshold)
    return _build_candidates(video_ids, proposals,
                             lambda i: (topk_values[i], topk_classes[i]),
                             score_threshold)


def nms_per_video(
    candidates: Dict[str, Dict[str, np.ndarray]],
    *,
    iou_threshold: float = 0.1,
    min_score: float = 0.001,
    sigma: float = 0.25,
    method: int = 2,
    nms_kind: str = "soft",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Multi-class Soft-NMS per video, detections score-sorted."""
    out = {}
    for vid, entry in candidates.items():
        segs, scores, labels = batched_nms(
            entry["segments"], entry["scores"], entry["labels"],
            iou_threshold=iou_threshold, min_score=min_score, sigma=sigma,
            method=method, nms_kind=nms_kind, multi_class=True)
        order = np.argsort(-scores, kind="stable")
        out[vid] = {"segments": np.round(segs[order], 3),
                    "scores": scores[order], "labels": labels[order]}
    return out
