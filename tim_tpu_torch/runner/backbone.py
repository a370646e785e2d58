"""Backbone training runners (EK100 finetune, MAE pretraining): counterpart
of ``tim_tpu/runner/backbone.py``.

- ``TwoHeadViT``: any feature trunk (``VideoMAEViT``, or
  ``SwinTransformer3D`` through ``make_two_head_step``) plus verb/noun
  heads;
- ``make_two_head_step``: mixup, soft-target CE on both heads, backward,
  optimizer update;
- ``BackboneFinetuneRunner``: layer-decayed AdamW over a ViT trunk. Like
  the JAX runner, ``init_state`` reads ``trunk.depth``, which a Swin trunk
  does not have: Swin trains through the step, as
  ``scripts/bench_finetune_swin.py`` drives it;
- ``BackbonePretrainRunner``: tube masks on the host, reconstruction on
  the device.

The models live on the device they were built on (the CUDA card unless
the CPU was asked for); batches move there as they are drawn.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tim_tpu_torch.extract.masking import TubeMasking, batch_mask_indices
from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
from tim_tpu_torch.train.backbone_finetune import (
    Mixup, make_llrd_optimizer, make_pretrain_step, mixup_targets,
    soft_target_cross_entropy)
from tim_tpu_torch.train.state import TrainState
from tim_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)


class TwoHeadViT(nn.Module):
    """Trunk + verb/noun heads (EK100 finetune target,
    ``run_class_finetuning.py`` nb_classes=[97, 300]; the two CE losses
    are summed). Heads: ``head_verb`` / ``head_noun`` fp32 linears over
    the trunk's features cast to fp32, weights trunc_normal(0.02 *
    init_scale) and zero bias (the reference's trunc_normal(0.02) then
    weight and bias ``.mul_(init_scale)``). The heads go to the trunk's
    device; the model is put in training mode."""

    def __init__(self, trunk: nn.Module, num_verbs: int = 97,
                 num_nouns: int = 300, init_scale: float = 0.001, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.trunk = trunk
        self.num_verbs, self.num_nouns = num_verbs, num_nouns
        std = 0.02 * init_scale
        for name, n in (("head_verb", num_verbs), ("head_noun", num_nouns)):
            head = nn.Linear(trunk.num_features, n)
            with torch.no_grad():
                nn.init.trunc_normal_(head.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                head.bias.zero_()
            setattr(self, name, head)
        self.to(next(trunk.parameters()).device)
        self.train()

    def forward(self, video):
        feats = self.trunk(video).float()
        return (F.linear(feats, self.head_verb.weight, self.head_verb.bias),
                F.linear(feats, self.head_noun.weight, self.head_noun.bias))


def make_two_head_step(model: TwoHeadViT, *, mixup_alpha: float = 0.8,
                       smoothing: float = 0.1, seed: int = 0):
    """Finetune step: mixup over clips, soft-target CE on both heads, one
    optimizer update. step(state, batch{video, verb, noun}, lam=None,
    perm=None) -> metrics (loss, verb_acc, noun_acc; 0-d tensors on the
    device, no host sync)."""
    mixup = Mixup(mixup_alpha, seed)

    def step(state: TrainState, batch: Dict, *, lam: Optional[float] = None,
             perm=None):
        video, verbs, nouns = batch["video"], batch["verb"], batch["noun"]
        if lam is None:
            lam, perm = mixup.draw(video.shape[0])
        video = mixup.apply(video, lam, perm)
        perm = perm.to(verbs.device)
        tv = mixup_targets(verbs, perm, lam, model.num_verbs, smoothing)
        tn = mixup_targets(nouns, perm, lam, model.num_nouns, smoothing)
        lv, ln_ = model(video)
        loss = (soft_target_cross_entropy(lv, tv)
                + soft_target_cross_entropy(ln_, tn))
        loss.backward()
        metrics = {
            "loss": loss.detach(),
            "verb_acc": (lv.detach().argmax(-1) == verbs).float().mean(),
            "noun_acc": (ln_.detach().argmax(-1) == nouns).float().mean()}
        state.apply_gradients()
        return metrics

    return step


def _batches(dataset, batch_size: int, rng: np.random.Generator,
             shuffle: bool = True, drop_last: bool = True):
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order), batch_size):
        chunk = order[i:i + batch_size]
        if len(chunk) < batch_size and drop_last:
            return
        examples = [dataset[int(j)] for j in chunk]
        batch = {k: np.stack([e[k] for e in examples])
                 for k in examples[0]}
        if batch["video"].ndim == 6:     # [B, num_sample, T, H, W, 3]
            batch = {
                "video": batch["video"].reshape(-1,
                                                *batch["video"].shape[2:]),
                "verb": batch["verb"].reshape(-1),
                "noun": batch["noun"].reshape(-1),
            }
        yield batch


def shape_matched_merge(init: Mapping[str, torch.Tensor],
                        loaded: Mapping[str, torch.Tensor]) -> Dict:
    """Keep loaded entries whose name and shape match ``init`` (a state
    dict); keep ``init``'s values elsewhere, logging both directions
    (``tim_tpu/train/checkpoint.py:182``'s non-strict load)."""
    merged = {}
    for key, val in init.items():
        if key in loaded and tuple(loaded[key].shape) == tuple(val.shape):
            merged[key] = loaded[key]
        else:
            if key in loaded:
                logger.warning("shape mismatch for %s: ckpt %s vs init %s",
                               key, tuple(loaded[key].shape),
                               tuple(val.shape))
            else:
                logger.warning("missing from checkpoint: %s", key)
            merged[key] = val
    for key in loaded:
        if key not in init:
            logger.warning("unused checkpoint entry: %s", key)
    return merged


def _to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


class BackboneFinetuneRunner:
    """EK100 classification finetune with layer-decayed AdamW."""

    def __init__(self, model: TwoHeadViT, train_ds, val_ds, *,
                 batch_size: int = 2, epochs: int = 1, lr: float = 1e-3,
                 layer_decay: float = 0.75, weight_decay: float = 0.05,
                 mixup_alpha: float = 0.8, smoothing: float = 0.1,
                 warmup_epochs: int = 0, seed: int = 0,
                 output_dir: Optional[str] = None):
        self.model = model
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.device = next(model.parameters()).device
        self.logger = setup_logging(output_dir)
        self._hp = dict(lr=lr, layer_decay=layer_decay,
                        weight_decay=weight_decay,
                        warmup_epochs=warmup_epochs)
        self._step_fn = make_two_head_step(
            model, mixup_alpha=mixup_alpha, smoothing=smoothing, seed=seed)
        self.state = None

    def init_state(self, pretrained_encoder: Optional[Mapping] = None):
        """The optimizer over the model's current parameters, after
        merging the shape-matched entries of ``pretrained_encoder`` (a
        trunk state dict) into the trunk."""
        if pretrained_encoder is not None:
            trunk = self.model.trunk
            trunk.load_state_dict(shape_matched_merge(
                trunk.state_dict(), pretrained_encoder))
        steps_per_epoch = max(len(self.train_ds) // self.batch_size, 1) \
            if self.train_ds else 1
        # LLRD over the whole model: trunk params resolve to their block
        # depth, heads (and anything unrecognised) to depth + 1
        optimizer, schedule = make_llrd_optimizer(
            self.model, depth=self.model.trunk.depth,
            lr=self._hp["lr"], weight_decay=self._hp["weight_decay"],
            layer_decay=self._hp["layer_decay"],
            total_steps=steps_per_epoch * self.epochs,
            warmup_steps=steps_per_epoch * self._hp["warmup_epochs"])
        self.state = TrainState(self.model, optimizer, schedule)
        return self.state

    def fit(self) -> Dict[str, float]:
        if self.state is None:
            self.init_state()
        self.model.train()
        metrics = {}
        for epoch in range(self.epochs):
            ep_rng = np.random.default_rng(self.seed + epoch)
            for batch in _batches(self.train_ds, self.batch_size, ep_rng):
                metrics = self._step_fn(self.state,
                                        _to_device(batch, self.device))
            self.logger.info(
                "finetune epoch %d | loss %.4f | verb %.3f noun %.3f",
                epoch + 1, float(metrics.get("loss", np.nan)),
                float(metrics.get("verb_acc", np.nan)),
                float(metrics.get("noun_acc", np.nan)))
        return {k: float(v) for k, v in metrics.items()}

    def validate(self) -> Dict[str, float]:
        assert self.state is not None
        self.model.eval()
        n = v_ok = n_ok = 0
        with torch.inference_mode():
            for batch in _batches(self.val_ds, self.batch_size,
                                  np.random.default_rng(0), shuffle=False,
                                  drop_last=False):
                lv, ln_ = self.model(torch.from_numpy(batch["video"]).to(
                    self.device))
                v_ok += int((lv.argmax(-1).cpu().numpy()
                             == batch["verb"]).sum())
                n_ok += int((ln_.argmax(-1).cpu().numpy()
                             == batch["noun"]).sum())
                n += len(batch["verb"])
        self.model.train()
        return {"verb_top1": 100.0 * v_ok / max(n, 1),
                "noun_top1": 100.0 * n_ok / max(n, 1)}


class BackbonePretrainRunner:
    """MAE pretraining loop: tube masks on the host, reconstruction on the
    device, AdamW (optax.adamw: decay on every parameter)."""

    def __init__(self, model: PretrainVideoMAE, dataset, *,
                 mask_ratio: float = 0.9, batch_size: int = 2,
                 epochs: int = 1, lr: float = 1.5e-4,
                 weight_decay: float = 0.05, seed: int = 0,
                 output_dir: Optional[str] = None):
        self.model = model
        self.dataset = dataset
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.device = next(model.parameters()).device
        self.logger = setup_logging(output_dir)
        self.masking = TubeMasking(model.grid, mask_ratio)
        self._hp = dict(lr=lr, weight_decay=weight_decay)
        self._step_fn = make_pretrain_step(model)
        self.state = None

    def init_state(self):
        optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self._hp["lr"], betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self._hp["weight_decay"])
        self.state = TrainState(self.model, optimizer)
        return self.state

    def fit(self) -> Dict[str, float]:
        if self.state is None:
            self.init_state()
        self.model.train()
        metrics = {}
        for epoch in range(self.epochs):
            rng = np.random.default_rng(self.seed + epoch)
            for batch in _batches(self.dataset, self.batch_size, rng):
                video = torch.from_numpy(batch["video"]).to(self.device)
                vis, msk = batch_mask_indices(self.masking, video.shape[0],
                                              rng)
                metrics = self._step_fn(
                    self.state, video, torch.from_numpy(vis).to(self.device),
                    torch.from_numpy(msk).to(self.device))
            self.logger.info("pretrain epoch %d | loss %.4f", epoch + 1,
                             float(metrics.get("loss", np.nan)))
        return {k: float(v) for k, v in metrics.items()}
