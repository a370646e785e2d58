"""Window-vote ensembling and validation accumulators: a copy of
``tim_tpu/evals/meters.py``; ``reduce_across_processes`` merges the ranks'
accumulators over a mesh's data group (``parallel.mesh.Mesh``) in two
collectives, the sums in float64.

The reference's characteristic eval mechanic
(``recognition/.../utils/meters.py:490-599``): each GT action appears in
many overlapping windows; per-head raw logits are summed per action id,
the shared seen-count normalizes the sum, and softmax of the mean logits
feeds top-k accuracy. The accumulator is plain numpy (``np.add.at``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from tim_tpu_torch.evals.metrics import multitask_accuracy, topk_accuracy


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class WindowVoteAccumulator:
    """Accumulates per-head logits over all windows of a split.

    heads: mapping head name -> num_classes. Visual heads share
    ``v_action_ids``; the audio head uses ``a_action_ids``; both add into
    one shared seen-count, exactly like the reference meter."""

    VISUAL_HEADS = ("verb", "noun", "action")

    def __init__(self, num_actions: int, heads: Dict[str, int]):
        self.num_actions = num_actions
        self.sums = {
            h: np.zeros((num_actions, c), np.float64)
            for h, c in heads.items()
        }
        self.seen = np.zeros(num_actions, np.float64)
        self.v_labels = -np.ones((num_actions, 3), np.int64)
        self.a_labels = -np.ones(num_actions, np.int64)

    def update(
        self,
        logits: Dict[str, np.ndarray],       # head -> [B, Nq, C]
        v_action_ids: Optional[np.ndarray],  # [B, Nv], -1 padded
        a_action_ids: Optional[np.ndarray],  # [B, Na], -1 padded
        labels: Dict[str, np.ndarray],       # verb/noun/action/class_id
    ) -> None:
        if v_action_ids is not None:
            ids = v_action_ids.reshape(-1)
            valid = ids >= 0
            ids = ids[valid]
            for h in self.VISUAL_HEADS:
                if h in self.sums and h in logits:
                    flat = logits[h].reshape(-1, logits[h].shape[-1])
                    np.add.at(self.sums[h], ids, flat[valid])
            np.add.at(self.seen, ids, 1.0)
            for col, key in enumerate(("verb", "noun", "action")):
                if key in labels:
                    self.v_labels[ids, col] = labels[key].reshape(-1)[valid]
        if a_action_ids is not None and "audio" in self.sums:
            ids = a_action_ids.reshape(-1)
            valid = ids >= 0
            ids = ids[valid]
            flat = logits["audio"].reshape(-1, logits["audio"].shape[-1])
            np.add.at(self.sums["audio"], ids, flat[valid])
            np.add.at(self.seen, ids, 1.0)
            self.a_labels[ids] = labels["class_id"].reshape(-1)[valid]

    def reduce_across_processes(self, mesh) -> None:
        """Merge the ranks' accumulators over ``mesh``'s data group (its
        model ranks hold the same votes): logit sums and seen-counts add
        (each action may be voted on from several ranks; float64, summed
        by the collective, no atomics), labels take the max (-1 where
        unseen). No-op on one data rank."""
        heads = list(self.sums)
        parts = [self.sums[h] for h in heads] + [self.seen]
        flat = mesh.allreduce_host_array(
            np.concatenate([p.reshape(-1) for p in parts]), "sum")
        pieces = np.split(flat, np.cumsum([p.size for p in parts])[:-1])
        for h, piece in zip(heads, pieces):
            self.sums[h] = piece.reshape(self.sums[h].shape)
        self.seen = pieces[-1]
        n_v = self.v_labels.size
        labels = mesh.allreduce_host_array(np.concatenate(
            [self.v_labels.reshape(-1), self.a_labels]), "max")
        self.v_labels = labels[:n_v].reshape(self.v_labels.shape)
        self.a_labels = labels[n_v:]

    def ensembled_scores(self, head: str) -> Tuple[np.ndarray, np.ndarray]:
        """(softmaxed mean logits, labels) over actions seen for ``head``."""
        if head == "audio":
            valid = self.a_labels != -1
            labels = self.a_labels[valid]
        else:
            valid = self.v_labels[:, 2] != -1
            col = {"verb": 0, "noun": 1, "action": 2}[head]
            labels = self.v_labels[valid, col]
        seen = np.maximum(self.seen[valid], 1.0)[:, None]
        scores = _softmax(self.sums[head][valid] / seen)
        return scores, labels

    def summarize(self, dataset: str = "epic") -> Dict[str, float]:
        out: Dict[str, float] = {}
        action_scores = action_labels = None
        if "action" in self.sums:
            action_scores, action_labels = self.ensembled_scores("action")
            a1, a5 = topk_accuracy(action_scores, action_labels)
            out["action_top1"], out["action_top5"] = a1, a5
        if "verb" in self.sums and "noun" in self.sums:
            v_s, v_l = self.ensembled_scores("verb")
            n_s, n_l = self.ensembled_scores("noun")
            out["verb_top1"], out["verb_top5"] = topk_accuracy(v_s, v_l)
            out["noun_top1"], out["noun_top5"] = topk_accuracy(n_s, n_l)
            mt1, mt5 = multitask_accuracy((v_s, n_s), (v_l, n_l))
            out["verb_noun_top1"], out["verb_noun_top5"] = mt1, mt5
        if "audio" in self.sums:
            aud_scores, aud_labels = self.ensembled_scores("audio")
            out["audio_top1"], out["audio_top5"] = topk_accuracy(
                aud_scores, aud_labels)
            # AVE: audio-visual combined head (``meters.py:563-565``)
            if dataset == "ave" and action_scores is not None and \
                    len(action_scores) == len(aud_scores):
                combined = (action_scores + aud_scores) / 2.0
                out["combined_top1"], out["combined_top5"] = topk_accuracy(
                    combined, action_labels)
        return out


class LossAverager:
    """Running mean of scalar losses weighted by counts (``AverageMeter``)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    def update(self, values: Dict[str, float], count: float = 1.0) -> None:
        for k, v in values.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v) * count
            self.counts[k] = self.counts.get(k, 0.0) + count

    def averages(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1.0)
                for k in self.totals}
