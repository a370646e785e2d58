"""File-level detection evaluation CLI: counterpart of
``tim_tpu/evals/__main__.py`` over the port's copies of the evaluation
code (``evals/{format_predictions,ek100,anet}.py``). No device work; the
GT pickle is read by the port's own reader (``utils.pdpickle``), with no
pandas.

Reproduces the reference's two-program eval chain in one command
(``detection/eval_detection/format_predictions_epic.py:114-198`` →
``evaluate_detection_json_ek100.py``): read a dense prediction dump from
disk, threshold, per-video Soft-NMS, write + validate the challenge
submission JSON, and print per-tIoU mAP.

    python -m tim_tpu_torch.evals --dump out/dense_predictions.npz \
        --gt EPIC_100_validation.pkl --task verb \
        --submission out/verb_submission.json

The dump is the ``.npz`` written by ``tim_tpu_torch.cli --extract_feats``
(keys: video_ids, v_proposals/a_proposals, action/verb/noun/audio score
matrices) — the role of the reference's ``*_features.pth.tar``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


TASK_KEYS = {
    # task -> (score key in dump, proposal key in dump)
    "action": ("action", "v_proposals"),
    "verb": ("verb", "v_proposals"),
    "noun": ("noun", "v_proposals"),
    "audio": ("audio", "a_proposals"),
}


def build_parser():
    p = argparse.ArgumentParser(
        "python -m tim_tpu_torch.evals",
        description="Dense detection dump -> Soft-NMS -> submission JSON "
                    "-> mAP")
    p.add_argument("--dump", required=True,
                   help="dense_predictions.npz from --extract_feats")
    p.add_argument("--gt", required=True,
                   help="ground-truth annotation pickle (reference format)")
    p.add_argument("--task", default="action", choices=sorted(TASK_KEYS))
    p.add_argument("--dataset", default="epic",
                   choices=["epic", "perception", "epic_sounds"])
    p.add_argument("--score_threshold", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.25)
    p.add_argument("--iou_threshold", type=float, default=0.1)
    p.add_argument("--tiou", type=float, nargs="+",
                   default=[0.1, 0.2, 0.3, 0.4, 0.5])
    p.add_argument("--n_jobs", type=int, default=1)
    p.add_argument("--submission", default="",
                   help="write the challenge submission JSON here")
    p.add_argument("--challenge_json", default="",
                   help="also write the official triplet-format JSON "
                        "(verb/noun/'v,n' action) that the reference "
                        "evaluate_detection_json_ek100.py consumes — "
                        "action task only")
    p.add_argument("--noun_count", type=int, default=300,
                   help="nouns per verb for action-id decoding")
    p.add_argument("--label_column", default="class_id",
                   help="GT label column for non-EPIC datasets")
    p.add_argument("--num_classes", type=int, default=0,
                   help="class-count for submission label-range "
                        "validation; needed for top-k dumps, where the "
                        "dump itself no longer carries the full width")
    return p


def _generic_gt_columns(annotations, label_column: str):
    """GT columns for Perception/EPIC-Sounds pickles (a ``Table``): plain
    second-valued start/stop columns plus a class-id column
    (``format_predictions.py`` input contract)."""
    from tim_tpu_torch.evals.format_predictions import gt_to_columns

    cols = set(annotations.columns)
    if {"start_seconds", "stop_seconds"} <= cols:
        starts = np.asarray(annotations["start_seconds"], float)
        stops = np.asarray(annotations["stop_seconds"], float)
    elif {"start_timestamp", "stop_timestamp"} <= cols:
        from tim_tpu_torch.data.windows import timestamp_to_seconds
        starts, stops = (np.asarray([timestamp_to_seconds(t) for t in
                                     annotations[c]], float)
                         for c in ("start_timestamp", "stop_timestamp"))
    else:
        raise SystemExit(
            f"GT pickle has no recognised time columns (got {sorted(cols)})")
    return gt_to_columns(annotations["video_id"].astype(object),
                         starts, stops, annotations[label_column])


def main(argv=None):
    from tim_tpu_torch.evals.ek100 import gt_columns_from_annotations
    from tim_tpu_torch.evals.format_predictions import (
        evaluate_detections, validate_submission)
    from tim_tpu_torch.utils.pdpickle import read_pickle

    args = build_parser().parse_args(argv)
    score_key, prop_key = TASK_KEYS[args.task]

    dump = np.load(args.dump, allow_pickle=True)
    if (score_key not in dump
            and f"{score_key}_topk_values" not in dump
            and args.task in ("verb", "noun")
            and ("action" in dump or "action_topk_values" in dump)):
        # verb/noun-stream models (the reference DEFAULT: verb_only,
        # visual_classes=(97,)) dump their single head under 'action';
        # the reference formatter reads outs['action'] for EVERY task
        # (format_predictions_epic.py:118-130) — the task only changes
        # how GT labels decode. Fall back to it.
        print(f"note: dump has no '{score_key}' head — using the "
              f"single-stream 'action' scores (reference semantics for "
              f"a {args.task}-stream model)", file=sys.stderr)
        score_key = "action"
    if score_key in dump:
        scores = dump[score_key]
    elif f"{score_key}_topk_values" in dump:
        # device-side top-k dump (extract_dense_predictions(top_k=...))
        scores = (dump[f"{score_key}_topk_values"],
                  dump[f"{score_key}_topk_classes"])
    else:
        raise SystemExit(
            f"dump has no '{score_key}' scores "
            f"(available: {sorted(dump.keys())}) — was the model trained "
            f"for this task?")
    video_ids = dump["video_ids"]
    proposals = dump[prop_key]

    annotations = read_pickle(args.gt)
    if args.dataset == "epic" and "verb_class" in annotations.columns:
        gt_cols = gt_columns_from_annotations(
            annotations, task=args.task, num_nouns=args.noun_count)
    else:
        gt_cols = _generic_gt_columns(annotations, args.label_column)

    challenge = ("audio_based_interaction_detection"
                 if args.task == "audio" else "action_detection")
    if args.challenge_json and args.task != "action":
        raise SystemExit(
            "--challenge_json decodes ACTION class ids into verb/noun "
            f"triplets; it cannot be produced from a {args.task!r} run")
    m_ap, avg, submission = evaluate_detections(
        video_ids, proposals, scores, gt_cols,
        score_threshold=args.score_threshold, sigma=args.sigma,
        iou_threshold=args.iou_threshold, tiou_thresholds=args.tiou,
        n_jobs=args.n_jobs,
        submission_path=args.submission or None,
        task=args.task, challenge=challenge,
        challenge_json_path=args.challenge_json or None,
        num_nouns=args.noun_count)
    if not isinstance(scores, tuple):
        # dense dumps carry their own width — authoritative, never
        # widened by --num_classes (that flag exists for top-k dumps)
        num_classes = int(scores.shape[-1])
    elif args.num_classes:
        num_classes = args.num_classes
    else:
        # top-k dumps only carry referenced class ids, so a bound derived
        # from them cannot catch out-of-range labels — say so instead of
        # validating vacuously (pass --num_classes to enable the check)
        num_classes = int(np.max(scores[1])) + 1 if scores[1].size else 1
        print("note: top-k dump without --num_classes — submission "
              "label-range validation is skipped", file=sys.stderr)
    validate_submission(submission, task=args.task,
                        num_classes=num_classes)

    # reference evaluator output shape: one line per tIoU + average
    for t, v in zip(args.tiou, m_ap):
        print(f"mAP @ tIoU {t:.2f}: {v * 100:.2f}%")
    print(f"Average mAP ({args.task}): {avg * 100:.2f}%")
    result = {"task": args.task,
              "tiou": list(args.tiou),
              "mAP": [float(v) for v in m_ap],
              "avg_mAP": float(avg)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
