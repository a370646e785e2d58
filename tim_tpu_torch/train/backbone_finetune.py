"""Backbone (VideoMAE ViT) classification finetuning: counterpart of
``tim_tpu/train/backbone_finetune.py``.

- layer-wise learning-rate decay (``optim_factory.py:30-58``): scale
  ``decay^(depth + 1 - layer)``, embeddings at layer 0, block i at i + 1,
  the rest (norm, heads) at depth + 1;
- soft-target cross entropy with label smoothing and batch-level mixup;
- AdamW + warmup-cosine, no weight decay on biases and 1-D parameters.

``make_llrd_optimizer`` is ``torch.optim.AdamW`` with one param group per
(layer scale, decay) whose lr is ``schedule(step) * scale``; the gradients
are first clipped to a global norm as ``optax.clip_by_global_norm`` does
(scaled by ``clip_norm / norm``, not ``clip_norm / (norm + 1e-6)`` as
``clip_grad_norm_``). Together that is optax's chain ``clip -> adam ->
decayed weights -> layer scale -> lr`` (``backbone_finetune.py:84-90``):
torch's decoupled decay ``p *= 1 - lr * wd`` is optax's ``- lr * wd * p``.
Mixup draws lam from a seeded ``np.random.Generator`` and the permutation
from ``torch.randperm`` with a seeded generator (JAX's draws come from its
PRNG keys and differ); a step also takes lam and perm when given.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tim_tpu_torch.train.optim import warmup_cosine_schedule
from tim_tpu_torch.train.state import TrainState


def vit_layer_index(name: str, depth: int) -> int:
    """Parameter name -> LLRD layer id (``optim_factory.py:30-42``): patch
    embedding and position tables at 0, ``blocks.{i}`` at i + 1,
    everything else (norms, heads, the MAE decoder) at depth + 1. A
    ``trunk.`` prefix (``TwoHeadViT``) is skipped."""
    parts = name.split(".")
    if parts[0] == "trunk":
        parts = parts[1:]
    if parts[0] in ("patch_embed", "pos_embed", "cls_token"):
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return depth + 1


def no_weight_decay(name: str, param: torch.Tensor) -> bool:
    """Biases, norm scales and every other parameter of at most one dim
    skip weight decay (``_no_decay``)."""
    return name.rsplit(".", 1)[-1] == "bias" or param.dim() <= 1


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every gradient is scaled by ``max_norm / norm``. Returns
    the norm (on the device; no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the gradients of all its
    parameters to a global norm of ``clip_norm``."""

    def __init__(self, params, *, clip_norm: float, **kwargs):
        super().__init__(params, **kwargs)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            clip_by_global_norm_(grads, self.clip_norm)
        return super().step(closure)


def make_llrd_optimizer(
    model: torch.nn.Module,
    *,
    depth: int,
    lr: float,
    weight_decay: float = 0.05,
    layer_decay: float = 0.75,
    total_steps: int = 1000,
    warmup_steps: int = 100,
    min_lr: float = 1e-6,
    clip_norm: float = 5.0,
):
    """(optimizer, schedule): AdamW with per-layer lr scales (the groups'
    ``lr_scale``) and selective weight decay, clipped; ``TrainState`` sets
    each group's lr to ``schedule(step) * lr_scale`` before a step."""
    schedule = warmup_cosine_schedule(lr, min_lr, total_steps, warmup_steps)
    groups: Dict[tuple, list] = {}
    for name, param in model.named_parameters():
        if not param.requires_grad:
            continue
        scale = layer_decay ** (depth + 1 - vit_layer_index(name, depth))
        decay = not no_weight_decay(name, param)
        groups.setdefault((scale, decay), []).append(param)
    param_groups = [
        {"params": params, "lr_scale": scale, "lr": schedule(0) * scale,
         "weight_decay": weight_decay if decay else 0.0}
        for (scale, decay), params in groups.items()]
    optimizer = ClippedAdamW(param_groups, clip_norm=clip_norm, lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)
    return optimizer, schedule


def soft_target_cross_entropy(logits, targets):
    """Mean CE against soft target distributions (timm
    SoftTargetCrossEntropy, used with mixup)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.mean(torch.sum(-targets * logp, dim=-1))


def mixup_targets(labels, perm, lam: float, num_classes: int,
                  smoothing: float = 0.1):
    """Smoothed one-hot targets blended by the mixup coefficient."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    onehot = F.one_hot(labels.long(), num_classes).float() * (on - off) + off
    return lam * onehot + (1.0 - lam) * onehot[perm]


class Mixup:
    """Batch mixup draws: lam ~ Beta(alpha, alpha) from a numpy Generator
    and a permutation from ``torch.randperm``, both seeded; alpha <= 0
    gives lam 1 and the identity."""

    def __init__(self, alpha: float, seed: int = 0):
        self.alpha = alpha
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator().manual_seed(seed)

    def draw(self, batch: int):
        if self.alpha <= 0:
            return 1.0, torch.arange(batch)
        return (float(self.rng.beta(self.alpha, self.alpha)),
                torch.randperm(batch, generator=self.gen))

    def apply(self, video, lam: float, perm):
        """``lam * video + (1 - lam) * video[perm]`` in video's dtype."""
        if lam == 1.0:
            return video
        perm = perm.to(video.device)
        return (lam * video + (1.0 - lam) * video[perm]).to(video.dtype)


def make_finetune_step(
    apply_fn: Callable,       # video -> logits (the model in training mode)
    num_classes: int,
    *,
    mixup_alpha: float = 0.8,
    smoothing: float = 0.1,
    seed: int = 0,
):
    """Returns step(state, batch{video, label}, lam=None, perm=None) ->
    metrics (loss, train_acc; 0-d tensors on the device, no host sync)."""
    mixup = Mixup(mixup_alpha, seed)

    def step(state: TrainState, batch: Dict, *, lam: Optional[float] = None,
             perm=None):
        video, labels = batch["video"], batch["label"]
        if lam is None:
            lam, perm = mixup.draw(video.shape[0])
        video = mixup.apply(video, lam, perm)
        targets = mixup_targets(labels, perm.to(labels.device), lam,
                                num_classes, smoothing)
        logits = apply_fn(video)
        loss = soft_target_cross_entropy(logits, targets)
        loss.backward()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        state.apply_gradients()
        return {"loss": loss.detach(), "train_acc": acc}

    return step


def make_pretrain_step(model):
    """MAE pretraining step: masked-tube pixel reconstruction
    (``models/backbones/mae.py``; masks are sampled on the host by
    ``extract/masking.py``). step(state, video, visible_idx, masked_idx)
    -> {"loss"}."""
    from tim_tpu_torch.models.backbones.mae import pretrain_loss

    def step(state: TrainState, video, visible_idx, masked_idx):
        pred = model(video, visible_idx, masked_idx)
        loss = pretrain_loss(pred, video, masked_idx, model.tubelet_size,
                             model.patch_size)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step
