"""ANET-style temporal detection mAP: a copy of ``tim_tpu/evals/anet.py``
(numpy only; tests pin it to the original).

The evaluation protocol of the reference's
``detection/eval_detection/evaluate_detection_json_ek100.py:83-290`` (the
ActivityNet devkit protocol): per-class VOC-interpolated average
precision at tIoU thresholds {0.1..0.5}, greedy one-to-one GT matching in
descending score order, averaged over classes then thresholds.
``n_jobs > 1`` spreads the classes over worker processes
(``parallel_map``: the standard library's process pool, results in input
order, so the same AP array as ``n_jobs = 1``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np


def _call(fn_args):
    fn, args = fn_args
    return fn(*args)


def parallel_map(fn: Callable, items: Iterable[tuple], n_jobs: int) -> List:
    """``[fn(*args) for args in items]``, over ``n_jobs`` worker processes
    (a ``concurrent.futures.ProcessPoolExecutor``, spawned, so a parent
    that holds a CUDA context is safe) where ``n_jobs > 1``; results in
    the order of ``items``. ``fn`` must be a module-level function."""
    items = list(items)
    if n_jobs <= 1 or len(items) <= 1:
        return [fn(*args) for args in items]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            max_workers=min(n_jobs, len(items)),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_call, [(fn, args) for args in items]))


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """IoU of one [2] segment against [N, 2] candidates."""
    lo = np.maximum(target[0], candidates[:, 0])
    hi = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(hi - lo, 0.0, None)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (target[1] - target[0]) - inter)
    return inter.astype(float) / union


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """VOC 2011 interpolated AP. The right-to-left running max is a
    reversed ``np.maximum.accumulate`` (identical to the reference's
    Python loop, ``evaluate_detection_json_ek100.py:279-288``, without the
    per-prediction interpreter cost)."""
    mprec = np.concatenate([[0.0], prec, [0.0]])
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.flatnonzero(mrec[1:] != mrec[:-1]) + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(
    gt_videos: np.ndarray, gt_segments: np.ndarray,
    pred_videos: np.ndarray, pred_segments: np.ndarray,
    pred_scores: np.ndarray,
    tiou_thresholds: np.ndarray,
) -> np.ndarray:
    """AP at each tIoU for one class. Greedy GT locking: each GT segment is
    creditable to at most one prediction per threshold."""
    n_thr = len(tiou_thresholds)
    ap = np.zeros(n_thr)
    npos = float(len(gt_segments))
    if len(pred_segments) == 0 or npos == 0:
        return ap

    order = np.argsort(-pred_scores, kind="stable")
    pred_videos = pred_videos[order]
    pred_segments = pred_segments[order]

    # group GT rows by video (original row order within a video, so the
    # greedy tie-breaks match the reference's per-prediction walk)
    gt_by_video: Dict = {}
    for i, v in enumerate(gt_videos):
        gt_by_video.setdefault(v, []).append(i)

    n_pred = len(pred_segments)
    tp = np.zeros((n_thr, n_pred))

    # Greedy locking only couples predictions within ONE video (a GT can
    # only match its own video's predictions), and tp positions are keyed
    # by global score rank — so the match runs per video with IoUs
    # computed as one [P, G] batch instead of a segment_iou call per
    # prediction (the reference's loop,
    # ``evaluate_detection_json_ek100.py:189-231``). Predictions whose
    # best IoU is below a threshold are false positives there without
    # entering the walk — on detector output that skips the vast
    # majority of (prediction, threshold) pairs.
    pred_by_video: Dict = {}
    for i, v in enumerate(pred_videos):
        pred_by_video.setdefault(v, []).append(i)

    for vid, pos in pred_by_video.items():
        gt_rows = gt_by_video.get(vid)
        if gt_rows is None:
            continue
        pos = np.asarray(pos)
        gts = gt_segments[np.asarray(gt_rows)]
        segs = pred_segments[pos]
        lo = np.maximum(segs[:, None, 0], gts[None, :, 0])
        hi = np.minimum(segs[:, None, 1], gts[None, :, 1])
        inter = np.clip(hi - lo, 0.0, None)
        union = ((gts[:, 1] - gts[:, 0])[None, :]
                 + (segs[:, 1] - segs[:, 0])[:, None] - inter)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter.astype(float) / union  # 0/0 -> NaN, like the ref
        # EXACTLY the reference's `tiou_arr.argsort()[::-1]` per row:
        # ascending-then-reverse puts NaN FIRST (so the walk sees it and
        # `NaN < thr` does not break — a zero-length prediction on a
        # zero-length GT is a true positive there) and reverses tie
        # order the same way
        by_iou = np.argsort(iou, axis=1)[:, ::-1]
        iou_sorted = np.take_along_axis(iou, by_iou, axis=1)
        n_gt = iou.shape[1]
        for t, thr in enumerate(tiou_thresholds):
            locked = np.zeros(n_gt, bool)
            # gate must be the NEGATION of the walk's break condition
            # (`iou < thr`), not `iou >= thr`: a NaN IoU (zero-length
            # prediction on zero-length GT — 0/0) fails both `<` and
            # `>=`, and the reference's per-prediction loop therefore
            # does NOT break on it and credits a true positive
            for r in np.flatnonzero(~(iou_sorted[:, 0] < thr)):
                row_iou = iou_sorted[r]
                row_gt = by_iou[r]
                for k in range(n_gt):
                    if row_iou[k] < thr:
                        break
                    g = row_gt[k]
                    if locked[g]:
                        continue
                    locked[g] = True
                    tp[t, pos[r]] = 1
                    break

    fp = 1.0 - tp
    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    recall = tp_cum / npos
    precision = tp_cum / (tp_cum + fp_cum)
    for t in range(n_thr):
        ap[t] = interpolated_prec_rec(precision[t], recall[t])
    return ap


def _rows_by_label(labels: np.ndarray) -> dict:
    """label -> row-index array, in original row order (one stable
    argsort instead of a boolean mask per class)."""
    order = np.argsort(labels, kind="stable")
    labs, starts = np.unique(labels[order], return_index=True)
    bounds = np.append(starts, len(order))
    return {lb: order[bounds[i]:bounds[i + 1]]
            for i, lb in enumerate(labs)}


class DetectionEvaluator:
    """mAP over classes present in the ground truth.

    Inputs are column dicts (or ``Table``s) with keys
    ``video-id, t-start, t-end, label`` (+ ``score`` for predictions).
    Predictions with labels absent from the GT are dropped, matching
    ``evaluate_detection_json_ek100.py:98-105``.
    """

    def __init__(
        self,
        ground_truth,
        prediction,
        tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
        n_jobs: int = 1,
    ):
        self.tiou = np.asarray(tiou_thresholds, float)
        self.gt = {k: np.asarray(ground_truth[k]) for k in
                   ("video-id", "t-start", "t-end", "label")}
        self.pred = {k: np.asarray(prediction[k]) for k in
                     ("video-id", "t-start", "t-end", "label", "score")}
        self.n_jobs = n_jobs

        gt_labels = np.unique(self.gt["label"])
        keep = np.isin(self.pred["label"], gt_labels)
        self.pred = {k: v[keep] for k, v in self.pred.items()}
        self.labels = sorted(gt_labels.tolist())

        # group row indices by label ONCE (the reference's groupby):
        # per-class boolean masks over the full arrays would cost
        # O(classes x rows) — ~1e9 compares at EK100 action scale
        self._gt_rows = _rows_by_label(self.gt["label"])
        self._pred_rows = _rows_by_label(self.pred["label"])

    def _class_slices(self, label):
        g = self._gt_rows.get(label, np.empty(0, np.int64))
        p = self._pred_rows.get(label, np.empty(0, np.int64))
        return (
            self.gt["video-id"][g],
            np.stack([self.gt["t-start"][g], self.gt["t-end"][g]], -1),
            self.pred["video-id"][p],
            np.stack([self.pred["t-start"][p], self.pred["t-end"][p]], -1),
            self.pred["score"][p],
            self.tiou,
        )

    def _one_class(self, label):
        return compute_average_precision_detection(
            *self._class_slices(label))

    def evaluate(self) -> Tuple[np.ndarray, float, np.ndarray]:
        """Returns (mAP per tIoU, average mAP, per-class AP [T, C])."""
        if self.n_jobs > 1:
            # ship only each class's slices to the workers, not self
            results = parallel_map(
                compute_average_precision_detection,
                [self._class_slices(lb) for lb in self.labels], self.n_jobs)
        else:
            results = [self._one_class(lb) for lb in self.labels]
        ap = np.stack(results, axis=1) if results else np.zeros(
            (len(self.tiou), 0))
        m_ap = ap.mean(axis=1) if ap.size else np.zeros(len(self.tiou))
        return m_ap, float(m_ap.mean()), ap
