"""Loss primitives: counterpart of ``tim_tpu/ops/losses.py``.

- label-smoothed cross entropy with ignored labels, and its mixup form;
- mixup of a batch's inputs, on a permutation and weight drawn by the
  caller;
- RetinaNet sigmoid focal loss, on explicit (soft) targets and on the
  detection's smoothed one-hot targets given by integer labels;
- 1-D center DIoU loss;
- dense relative localization (drloc), on positions drawn by the caller;
- the detection's smoothed one-hot labels.

Plain PyTorch (autograd takes the gradients). Masked reductions use
weights, not boolean indexing, so that shapes do not depend on the data.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def valid_labels(labels, num_classes: int, ignore_index: int = -1):
    """The rows whose label counts: not ``ignore_index``, in [0, C)."""
    return (labels != ignore_index) & (labels >= 0) & (labels < num_classes)


def cross_entropy(logits, labels, *, label_smoothing: float = 0.0,
                  ignore_index: int = -1, weights=None,
                  reduction: str = "mean", count=None):
    """Label-smoothed cross entropy over the last axis, in fp32: per row
    ``(1 - eps) * nll + eps * (-mean log p)``. Rows whose label is
    ``ignore_index`` or out of [0, C) add nothing (JAX cannot raise under
    jit, so it ignores them; so does the port), and the mean divides by
    the count of the other rows (at least 1), or by ``count`` when given
    (a rank's share of a global batch's mean: the global count)."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = valid_labels(labels, num_classes, ignore_index)
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    smooth = -logp.mean(-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    loss = torch.where(valid, loss, 0.0)
    if weights is not None:
        loss = loss * weights
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.sum() if count is None else count,
                                    min=1)


def mixup_draws(rng: np.random.Generator, batch: int, alpha: float
                ) -> Tuple[torch.Tensor, float]:
    """(perm [batch] int64, lam): the batch permutation and the weight
    ``lam ~ Beta(alpha, alpha)`` (1.0 when ``alpha <= 0``), drawn from
    ``rng``, weight first."""
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    return torch.from_numpy(rng.permutation(batch)), lam


def mixup(inputs, perm: torch.Tensor, lam: float):
    """``lam * x + (1 - lam) * x[perm]`` along the batch axis for every x
    of ``inputs``, the JAX way: ``lam`` is first rounded to the dtype of
    ``inputs[0]``, then each x mixes in the promotion of that dtype and
    its own (so bf16 time encodings mix in fp32 beside fp32 features, and
    in bf16 steps beside bf16 ones)."""
    lam_t = torch.tensor(np.float32(lam)).to(inputs[0].dtype)
    out = []
    for x in inputs:
        dt = torch.promote_types(lam_t.dtype, x.dtype)
        lam_x = lam_t.to(device=x.device, dtype=dt)
        x = x.to(dt)
        out.append(lam_x * x + (1.0 - lam_x) * x[perm.to(x.device)])
    return tuple(out)


def mixup_cross_entropy(logits, labels_a, labels_b, lam, *,
                        label_smoothing: float = 0.0, counts=(None, None)):
    """``lam * CE(logits, labels_a) + (1 - lam) * CE(logits, labels_b)``,
    each the mean over its own valid rows (the reference selects each
    side's valid rows apart); ``counts``: each side's denominator, when
    given (see ``cross_entropy``)."""
    loss_a = cross_entropy(logits, labels_a, label_smoothing=label_smoothing,
                           count=counts[0])
    loss_b = cross_entropy(logits, labels_b, label_smoothing=label_smoothing,
                           count=counts[1])
    return lam * loss_a + (1.0 - lam) * loss_b


def _focal(x, t, alpha: float, gamma: float):
    """Elementwise focal loss of fp32 logits ``x`` against targets ``t`` (a
    tensor broadcasting against ``x``, or one number for every entry)."""
    p = torch.sigmoid(x)
    # numerically stable BCE with logits
    ce = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    return loss


def sigmoid_focal_loss(logits, targets, *, alpha: float = 0.25,
                       gamma: float = 2.0, weights=None,
                       reduction: str = "none"):
    """RetinaNet focal loss on (soft) binary targets of the logits' shape."""
    loss = _focal(logits.float(), targets.float(), alpha, gamma)
    if weights is not None:
        loss = loss * weights
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss_smoothed(logits, labels, smoothing: float, *,
                                alpha: float = 0.25, gamma: float = 2.0,
                                weights=None):
    """The weighted SUM of the focal loss of logits [N, C] against the
    smoothed one-hot targets of int labels [N] (-1: a negative, the floor
    everywhere; ``smooth_positive_labels``), without an [N, C] target
    tensor: every entry's target is the floor ``(1 - s) / (C + 1)`` except
    each row's label column, whose target is ``floor + s``. So the loss
    runs over all entries with the floor as one number, and the label
    column, gathered by its index, trades its floor term for its peak
    term. (At EPIC scale an explicit target tensor is ~0.4 GB fp32 per
    modality; the JAX package builds the targets from an iota for the
    same reason.)"""
    n, c = logits.shape
    floor = np.float32((1.0 - smoothing) / (c + 1))
    peak = floor + np.float32(smoothing)          # fp32, as the JAX sum
    x = logits.float()
    loss = _focal(x, float(floor), alpha, gamma)
    if weights is not None:
        loss = loss * weights[:, None]
    positive = labels >= 0
    x_label = x.gather(1, labels.clamp(min=0)[:, None].long())[:, 0]
    trade = (_focal(x_label, float(peak), alpha, gamma)
             - _focal(x_label, float(floor), alpha, gamma))
    if weights is not None:
        trade = trade * weights
    return loss.sum() + torch.where(positive, trade, 0.0).sum()


def ctr_diou_loss_1d(input_offsets, target_offsets, *, weights=None,
                     reduction: str = "none", eps: float = 1e-8):
    """1-D distance-IoU on (left, right) offsets from a shared center."""
    input_offsets = input_offsets.float()
    target_offsets = target_offsets.float()
    lp, rp = input_offsets[..., 0], input_offsets[..., 1]
    lg, rg = target_offsets[..., 0], target_offsets[..., 1]

    inter = torch.minimum(lp, lg) + torch.minimum(rp, rg)
    union = (lp + rp) + (lg + rg) - inter
    iou = inter / torch.clamp(union, min=eps)

    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    loss = 1.0 - iou + torch.square(rho / torch.clamp(len_c, min=eps))
    if weights is not None:
        loss = loss * weights
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def drloc_positions(generator: torch.Generator, n: int, length: int,
                    m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``m`` random token positions per batch row, twice: two [n, m] int64
    tensors in [0, length) from ``generator`` (a CPU generator)."""
    return tuple(torch.randint(0, length, (n, m), generator=generator)
                 for _ in range(2))


def drloc_loss(positions: Tuple[torch.Tensor, torch.Tensor], x1, x2,
               mlp_apply: Callable[[torch.Tensor], torch.Tensor]):
    """Dense relative localization loss: the drloc MLP predicts
    |pos1 - pos2| / L from the concatenated token pair at the two sampled
    positions of ``x1`` and ``x2`` [n, L, D] (the same tensor twice for
    the unimodal variant); returns the mean L1 error. ``positions``: the
    two [n, m] position tensors (``drloc_positions``)."""
    length = x1.shape[1]
    pos_1, pos_2 = (p.to(x1.device) for p in positions)
    delta = (pos_1 - pos_2).float().abs() / length

    def take(x, pos):
        # the rows at pos [n, m] of x [n, L, D] as a product with their
        # one-hot selector: exact, and its backward is a GEMM, where a
        # gather's scatter-adds the repeated positions by atomics, in
        # another order each run on the card
        return torch.bmm(F.one_hot(pos, length).to(x.dtype), x)

    pred = mlp_apply(torch.cat([take(x1, pos_1), take(x2, pos_2)], dim=-1))
    return (delta - pred.float()).abs().mean()


def smooth_positive_labels(labels, num_classes: int, smoothing: float):
    """One-hot labels smoothed the detection way: negatives (label -1) map
    to a dummy class C that is dropped, leaving the floor
    ``(1 - s) / (C + 1)`` everywhere; positives peak at
    ``s + (1 - s) / (C + 1)``."""
    mapped = torch.where(labels == -1, num_classes, labels).long()
    onehot = F.one_hot(mapped, num_classes + 1).float()
    soft = onehot * smoothing + (1.0 - smoothing) / (num_classes + 1)
    return soft[..., :-1]

