"""EPIC-KITCHENS-100 detection-challenge evaluation: a copy of
``tim_tpu/evals/ek100.py`` (tests pin it to the original).

A task-aware wrapper over the mAP evaluator, as the reference's
``detection/eval_detection/evaluate_detection_json_ek100.py``: ground truth
from the EPIC annotation table (a ``data.table.Table``: timestamps +
verb/noun classes; action id = verb * 300 + noun), predictions from the challenge submission dict
(entries carry verb, noun and an "v,n" composite action), evaluated per
task at tIoU {0.1..0.5}.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from tim_tpu_torch.data.windows import timestamp_to_seconds
from tim_tpu_torch.evals.anet import DetectionEvaluator


def gt_columns_from_annotations(
    annotations, task: str = "action", num_nouns: int = 300
) -> Dict:
    """EPIC annotation ``Table`` -> evaluator columns
    (``evaluate_detection_json_ek100.py:24-43``)."""
    starts, stops = (np.asarray([timestamp_to_seconds(t) for t in
                                 annotations[c]], float)
                     for c in ("start_timestamp", "stop_timestamp"))
    verbs = annotations["verb_class"]
    nouns = annotations["noun_class"]
    if task == "verb":
        label = verbs
    elif task == "noun":
        label = nouns
    else:
        label = verbs * num_nouns + nouns
    return {
        "video-id": annotations["video_id"].astype(object),
        "t-start": starts,
        "t-end": stops,
        "label": label,
    }


def prediction_columns_from_submission(
    submission: Dict, task: str = "action", num_nouns: int = 300
) -> Dict:
    """Challenge submission dict -> evaluator columns
    (``evaluate_detection_json_ek100.py:45-82``). Detection entries carry
    ``verb``/``noun`` ints and an ``action`` composite "v,n" string."""
    vids, starts, stops, labels, scores = [], [], [], [], []
    for vid, entries in submission["results"].items():
        for e in entries:
            vids.append(vid)
            starts.append(float(e["segment"][0]))
            stops.append(float(e["segment"][1]))
            scores.append(float(e["score"]))
            if task == "verb":
                labels.append(int(e["verb"]))
            elif task == "noun":
                labels.append(int(e["noun"]))
            else:
                v, n = str(e["action"]).split(",")
                labels.append(int(v) * num_nouns + int(n))
    return {
        "video-id": np.asarray(vids, object),
        "t-start": np.asarray(starts, float),
        "t-end": np.asarray(stops, float),
        "label": np.asarray(labels),
        "score": np.asarray(scores, float),
    }


def evaluate_ek100(
    annotations,
    submission: Dict,
    task: str = "action",
    *,
    num_nouns: int = 300,
    tiou_thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
    n_jobs: int = 1,
) -> Tuple[np.ndarray, float]:
    """(mAP per tIoU, average mAP) for one EK100 task."""
    evaluator = DetectionEvaluator(
        gt_columns_from_annotations(annotations, task, num_nouns),
        prediction_columns_from_submission(submission, task, num_nouns),
        tiou_thresholds=tiou_thresholds, n_jobs=n_jobs)
    m_ap, avg, _ = evaluator.evaluate()
    return m_ap, avg
