"""Dense prediction dump -> thresholded candidates -> per-video Soft-NMS
-> challenge submission -> mAP: a copy of
``tim_tpu/evals/format_predictions.py`` (tests pin it to the original).

The reference's chained programs (``format_predictions_epic.py`` then
``evaluate_detection_json_ek100.py``) in one process: threshold the scores
(> 0.03), expand multi-label proposals, multi-class Soft-NMS per video
(iou 0.1, sigma 0.25, min_score 0.001), build the EPIC challenge dict and
evaluate it (``evals/anet.py``). ``n_jobs > 1`` spreads the videos'
Soft-NMS over worker processes (``anet.parallel_map``), with results in
input order."""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from tim_tpu_torch.evals.anet import DetectionEvaluator, parallel_map
from tim_tpu_torch.evals.nms import batched_nms


def _nms_video(vid, entry, iou_threshold, min_score, sigma, method,
               nms_kind):
    """One video's multi-class Soft-NMS, detections score-sorted."""
    segs, scores, labels = batched_nms(
        entry["segments"], entry["scores"], entry["labels"],
        iou_threshold=iou_threshold, min_score=min_score, sigma=sigma,
        method=method, nms_kind=nms_kind, multi_class=True)
    order = np.argsort(-scores, kind="stable")
    return vid, {"segments": np.round(segs[order], 3),
                 "scores": scores[order], "labels": labels[order]}


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
    n_jobs: int = 1,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Multi-class Soft-NMS per video, detections score-sorted."""
    return dict(parallel_map(
        _nms_video, [(vid, entry, iou_threshold, min_score, sigma, method,
                      nms_kind) for vid, entry in candidates.items()],
        n_jobs))


def _build_submission_dict(detections, label_fields, challenge: str) -> Dict:
    """The challenge dict; ``label_fields(label)`` gives an entry's label
    fields."""
    results = {}
    for vid, det in detections.items():
        results[vid] = [
            dict(label_fields(label), score=float(score),
                 segment=[float(seg[0]), float(seg[1])])
            for seg, score, label in zip(det["segments"], det["scores"],
                                         det["labels"])]
    return {
        "version": "0.2",
        "challenge": challenge,
        "sls_pt": 2, "sls_tl": 3, "sls_td": 4,
        "results": results,
    }


def build_submission(
    detections: Dict[str, Dict[str, np.ndarray]],
    task: str = "action",
    challenge: str = "action_detection",
) -> Dict:
    """Single-task entries, like the reference formatter writes."""
    return _build_submission_dict(
        detections, lambda label: {task: int(label)}, challenge)


def build_challenge_submission(
    detections: Dict[str, Dict[str, np.ndarray]],
    num_nouns: int = 300,
    challenge: str = "action_detection",
) -> Dict:
    """Challenge-format JSON with the (verb, noun, action) triplet per
    entry that ``evaluate_detection_json_ek100.py:45-68``
    (load_predicted_segmentations) requires: int verb/noun fields plus
    the action as a ``"v,n"`` string. Detection labels are EPIC action
    class ids (``a = verb * num_nouns + noun``).

    Note: the reference's own formatter
    (``format_predictions_epic.py:134-139``) writes only a single
    ``{task: int}`` key, which its evaluator cannot load (``.split`` on
    an int) — the triplet format here is what the evaluator and the
    official challenge actually consume."""

    def triplet(label):
        verb, noun = int(label) // num_nouns, int(label) % num_nouns
        return {"verb": verb, "noun": noun, "action": f"{verb},{noun}"}

    return _build_submission_dict(detections, triplet, challenge)


def submission_to_columns(submission: Dict, task: str = "action") -> Dict:
    vids, starts, ends, labels, scores = [], [], [], [], []
    for vid, entries in submission["results"].items():
        for e in entries:
            vids.append(vid)
            starts.append(e["segment"][0])
            ends.append(e["segment"][1])
            labels.append(e[task])
            scores.append(e["score"])
    return {
        "video-id": np.asarray(vids, object),
        "t-start": np.asarray(starts, float),
        "t-end": np.asarray(ends, float),
        "label": np.asarray(labels),
        "score": np.asarray(scores, float),
    }


def gt_to_columns(video_ids, starts, ends, labels) -> Dict:
    return {
        "video-id": np.asarray(video_ids, object),
        "t-start": np.asarray(starts, float),
        "t-end": np.asarray(ends, float),
        "label": np.asarray(labels),
    }


class SubmissionError(ValueError):
    """Raised when a challenge submission dict is malformed."""


VALID_VERSIONS = ("0.1", "0.2")
VALID_CHALLENGES = ("action_detection", "audio_based_interaction_detection")


def validate_submission(
    submission: Dict,
    task: str = "action",
    num_classes: Optional[int] = None,
    video_ids: Optional[Sequence[str]] = None,
) -> None:
    """Schema validation of a challenge submission (the role of the
    exception machinery in ``evaluate_detection_json_ek100.py:317-573``):
    version/challenge tags, per-entry task label + score + ordered segment,
    label range, and (optionally) video-id coverage. Raises
    ``SubmissionError`` with a precise message."""
    for prop in ("version", "challenge", "results"):
        if prop not in submission:
            raise SubmissionError(f"Missing '{prop}' property")
    if submission["version"] not in VALID_VERSIONS:
        raise SubmissionError(
            f"Submission version '{submission['version']}' is not "
            f"supported, valid versions: {', '.join(VALID_VERSIONS)}")
    if submission["challenge"] not in VALID_CHALLENGES:
        raise SubmissionError(
            f"Challenge '{submission['challenge']}' is not supported, "
            f"valid challenges: {', '.join(VALID_CHALLENGES)}")
    results = submission["results"]
    if not isinstance(results, dict):
        raise SubmissionError("'results' must map video_id -> entries")
    if video_ids is not None:
        missing = set(video_ids) - set(results)
        if missing:
            raise SubmissionError(
                f"Missing results for video ids: {sorted(missing)[:10]}")
    for vid, entries in results.items():
        for i, e in enumerate(entries):
            for prop in (task, "score", "segment"):
                if prop not in e:
                    raise SubmissionError(
                        f"Missing '{prop}' property for {vid}[{i}]")
            seg = e["segment"]
            if len(seg) != 2 or not seg[0] < seg[1]:
                raise SubmissionError(
                    f"Invalid segment {seg} for {vid}[{i}]")
            if num_classes is not None:
                label = e[task]
                if isinstance(label, str):
                    continue  # "verb,noun" composite labels
                if not (0 <= int(label) < num_classes):
                    raise SubmissionError(
                        f"Found invalid {task} class '{label}' "
                        f"for {vid}[{i}]")


def two_stream_fusion(
    video_ids: np.ndarray,
    verb_scores: np.ndarray,        # [N, Cv]
    noun_scores: np.ndarray,        # [N, Cn]
    verb_proposals: np.ndarray,     # [N, 2]
    noun_proposals: np.ndarray,     # [N, 2]
    *,
    verb_alpha: float = 0.65,
    score_threshold: float = 0.03,
    top_k: int = 3,
    num_nouns: int = 300,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Fuse separately-trained verb/noun detection streams into action
    proposals (``format_two_stream_predictions_epic.py:140-172``):
    geometric score fusion ``v^a * n^(1-a)``, verb-confidence-weighted
    proposal blending, action label ``verb * num_nouns + noun``."""
    out: Dict[str, Dict[str, List]] = {}
    n = len(video_ids)
    for i in range(n):
        vid = str(video_ids[i])
        v_top = np.argpartition(verb_scores[i], -top_k)[-top_k:]
        n_top = np.argpartition(noun_scores[i], -top_k)[-top_k:]
        for v in v_top:
            vs = verb_scores[i, v]
            if vs <= score_threshold:
                continue
            for nn_ in n_top:
                ns = noun_scores[i, nn_]
                if ns <= score_threshold:
                    continue
                score = (vs ** verb_alpha) * (ns ** (1.0 - verb_alpha))
                if score <= score_threshold:
                    continue
                w = vs / (vs + ns)
                proposal = np.round(
                    w * verb_proposals[i] + (1 - w) * noun_proposals[i], 3)
                if proposal[1] - proposal[0] <= 0.0:
                    continue
                entry = out.setdefault(
                    vid, {"segments": [], "scores": [], "labels": []})
                entry["segments"].append(proposal)
                entry["scores"].append(float(score))
                entry["labels"].append(int(v) * num_nouns + int(nn_))
    return {
        vid: {
            "segments": np.asarray(e["segments"], np.float32).reshape(-1, 2),
            "scores": np.asarray(e["scores"], np.float32),
            "labels": np.asarray(e["labels"], np.int64),
        } for vid, e in out.items()
    }


def evaluate_detections(
    video_ids: np.ndarray,
    proposals: np.ndarray,
    scores,                       # [N, C] dense, or (values, classes) top-k
    gt_columns: Dict,
    *,
    score_threshold: float = 0.03,
    sigma: float = 0.25,
    iou_threshold: float = 0.1,
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
    n_jobs: int = 1,
    submission_path: Optional[str] = None,
    task: str = "action",
    challenge: str = "action_detection",
    challenge_json_path: Optional[str] = None,
    num_nouns: int = 300,
    topk_num_classes: Optional[int] = None,
):
    """Full pipeline: dense dump -> mAP. Returns (mAP per tIoU, avg mAP,
    submission dict). ``challenge_json_path`` additionally writes the
    official challenge triplet format (action labels decoded to
    verb/noun via ``num_nouns``) consumable by the reference
    ``evaluate_detection_json_ek100.py`` main()."""
    if isinstance(scores, tuple):
        cands = threshold_predictions_topk(
            video_ids, proposals, *scores,
            score_threshold=score_threshold,
            num_classes=topk_num_classes)
    else:
        cands = threshold_predictions(video_ids, proposals, scores,
                                      score_threshold)
    dets = nms_per_video(cands, iou_threshold=iou_threshold, sigma=sigma,
                         n_jobs=n_jobs)
    submission = build_submission(dets, task=task, challenge=challenge)
    if submission_path:
        with open(submission_path, "w") as f:
            json.dump(submission, f, indent=4, separators=(",", ": "))
    if challenge_json_path:
        with open(challenge_json_path, "w") as f:
            json.dump(build_challenge_submission(
                dets, num_nouns=num_nouns, challenge=challenge), f,
                indent=4, separators=(",", ": "))
    evaluator = DetectionEvaluator(
        gt_columns, submission_to_columns(submission, task=task),
        tiou_thresholds=tiou_thresholds, n_jobs=n_jobs)
    m_ap, avg, _ = evaluator.evaluate()
    return m_ap, avg, submission
