"""Recognition train and eval steps: counterpart of
``tim_tpu/train/recognition.py``.

A train step encodes the times, mixes the batch (features and time
encodings, ``ops.losses.mixup``), runs the encoder with dropout, takes
the mixup-weighted masked cross entropy of each head and the drloc loss,
backpropagates and applies one optimizer update. It reads nothing back:
its metrics are 0-d device tensors.

Randomness. Every draw of a step derives from ``(TrainConfig.seed,
step)`` through one function (``make_step_draws``): the mixup weight and
permutation from a numpy generator, the drloc positions from a CPU
``torch.Generator`` (so that the card and the CPU draw the same ones), the
dropout masks from device generators seeded from the step's
``dropout_seed`` (``models.tim``).

Kernels. The train step runs the model with dropout, so it never reaches
kernel 1 (query-block attention) or kernel 2 (the fused tail), as in JAX;
the eval step is deterministic and reaches them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tim_tpu_torch.config import ModelConfig, TrainConfig
from tim_tpu_torch.data.device_bank import host_to_device
from tim_tpu_torch.models.tim import TimRecognition
from tim_tpu_torch.ops import losses as L
from tim_tpu_torch.train.detection import step_seeds, with_bank_features
from tim_tpu_torch.train.state import TrainState


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _head_losses(logits, batch, perm, lam: float, cfg: ModelConfig,
                 tcfg: TrainConfig):
    """The mixup-weighted masked cross entropy of each head. Returns
    (total, metrics)."""
    verb_l, noun_l, action_l, audio_l = logits

    def mix_ce(head_logits, labels):
        return L.mixup_cross_entropy(
            _flat(head_logits), labels.reshape(-1),
            labels[perm].reshape(-1), lam,
            label_smoothing=tcfg.label_smoothing)

    out = {}
    device = batch["times"].device
    visual_loss = audio_loss = torch.zeros((), device=device)
    if "visual" in cfg.data_modality:
        action_loss = mix_ce(action_l, batch["action"])
        if cfg.include_verb_noun:
            verb_loss = mix_ce(verb_l, batch["verb"])
            noun_loss = mix_ce(noun_l, batch["noun"])
            visual_loss = (verb_loss + noun_loss + action_loss) / 3.0
            out.update(loss_verb=verb_loss, loss_noun=noun_loss)
        else:
            visual_loss = action_loss
        out.update(loss_action=action_loss, loss_visual=visual_loss)
    if "audio" in cfg.data_modality:
        audio_loss = mix_ce(audio_l, batch["class_id"])
        out.update(loss_audio=audio_loss)

    if cfg.data_modality == "visual":
        total = visual_loss
    elif cfg.data_modality == "audio":
        total = audio_loss
    else:
        total = visual_loss + tcfg.lambda_audio * audio_loss
    return total, out


def _drloc(positions, ctx, model: TimRecognition, cfg: ModelConfig,
           tcfg: TrainConfig):
    if tcfg.lambda_drloc <= 0.0:
        return torch.zeros((), device=ctx.device)
    nf = cfg.num_feats
    if cfg.input_modality == "audio_visual":
        return L.drloc_loss(positions, ctx[:, :nf], ctx[:, nf:2 * nf],
                            model.drloc)
    return L.drloc_loss(positions, ctx, ctx, model.drloc)


@dataclass
class StepDraws:
    """A train step's random draws, on the CPU: the mixup permutation
    [B] and weight, the drloc position pair [B, m] (None without drloc),
    the dropout seed."""

    perm: torch.Tensor
    lam: float
    drloc: Optional[Tuple[torch.Tensor, torch.Tensor]]
    dropout_seed: int


def make_step_draws(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[int, int], StepDraws]:
    """draws(step, batch_size) -> StepDraws: from a numpy generator
    seeded by ``step_seeds(tcfg.seed, step)`` the mixup weight (an fp32
    value, as JAX draws it) and permutation, then the seed of the CPU
    torch generator of the drloc positions."""

    def draws(step: int, batch_size: int) -> StepDraws:
        cpu_seed, dropout_seed = step_seeds(tcfg.seed, step)
        rng = np.random.default_rng(cpu_seed)
        perm, lam = L.mixup_draws(rng, batch_size, tcfg.mixup_alpha)
        drloc = None
        if tcfg.lambda_drloc > 0.0:
            gen = torch.Generator().manual_seed(int(rng.integers(2 ** 62)))
            drloc = L.drloc_positions(gen, batch_size, cfg.num_feats,
                                      tcfg.m_drloc)
        return StepDraws(perm, float(np.float32(lam)), drloc, dropout_seed)

    return draws


def make_train_step(model: TimRecognition, cfg: ModelConfig,
                    tcfg: TrainConfig, num_v_queries: int,
                    num_a_queries: int,
                    draws: Optional[Callable[[int, int], StepDraws]] = None):
    """Returns train_step(state, batch) -> metrics: time encoding, mixup,
    the forward with dropout, the head and drloc losses, backward, one
    optimizer update (``state.apply_gradients``).

    ``batch``: tensors on the model's device with the
    ``RecognitionDataset`` keys (``times``, ``v_feats``/``a_feats``, the
    label rows). ``draws`` (default ``make_step_draws``) makes the step's
    random draws."""
    draws = draws or make_step_draws(cfg, tcfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        device = batch["times"].device
        d = draws(state.step, batch["times"].shape[0])
        perm = host_to_device(d.perm, device)
        inputs = [batch[k] for k, mod in (("v_feats", "visual"),
                                          ("a_feats", "audio"))
                  if mod in cfg.input_modality]
        *feats, te = L.mixup(inputs + [model.encode_times(batch["times"])],
                             perm, d.lam)
        v = feats[0] if "visual" in cfg.input_modality else None
        a = feats[-1] if "audio" in cfg.input_modality else None
        logits, ctx = model.encoder_forward(
            v, a, te, num_v_queries, num_a_queries,
            dropout_seed=d.dropout_seed)
        total, metrics = _head_losses(logits, batch, perm, d.lam, cfg, tcfg)
        dr = _drloc(d.drloc, ctx, model, cfg, tcfg)
        total = total + tcfg.lambda_drloc * dr
        metrics["loss_drloc"] = dr
        metrics["loss"] = total
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = state.apply_gradients()
        return metrics

    return train_step


def make_bank_train_step(model: TimRecognition, cfg: ModelConfig,
                         tcfg: TrainConfig, num_v_queries: int,
                         num_a_queries: int, v_bank=None, a_bank=None,
                         draws: Optional[Callable] = None):
    """The train step on features gathered from device-resident banks:
    the batch carries ``feat_indices`` [B, F] (``data.device_bank.
    DeviceWindowTables``) in place of the features; one augmentation set
    per token comes from a CPU generator seeded by
    ``step_seeds(tcfg.seed, step, 11)``."""
    base = make_train_step(model, cfg, tcfg, num_v_queries, num_a_queries,
                           draws)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        gen = torch.Generator().manual_seed(
            step_seeds(tcfg.seed, state.step, 11)[0])
        return base(state, with_bank_features(batch, v_bank, a_bank, gen))

    return step


def make_eval_step(model: TimRecognition, cfg: ModelConfig,
                   tcfg: TrainConfig, num_v_queries: int,
                   num_a_queries: int):
    """Returns eval_step(batch) -> (logits, losses): the raw logits [B, Nq,
    C] of each head (in the compute dtype, for the window-vote ensemble)
    and the cross entropy of each head, from the deterministic forward
    (kernel 1 on the card)."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]):
        (verb_l, noun_l, action_l, audio_l), _ = model(
            batch.get("v_feats"), batch.get("a_feats"), batch["times"],
            num_v_queries, num_a_queries)
        out_logits, out_losses = {}, {}

        def ce(head_logits, labels):
            return L.cross_entropy(_flat(head_logits), labels.reshape(-1),
                                   label_smoothing=tcfg.label_smoothing)

        if "visual" in cfg.data_modality:
            out_logits["action"] = action_l
            action_loss = ce(action_l, batch["action"])
            visual_loss = action_loss
            if cfg.include_verb_noun:
                out_logits["verb"] = verb_l
                out_logits["noun"] = noun_l
                verb_loss = ce(verb_l, batch["verb"])
                noun_loss = ce(noun_l, batch["noun"])
                visual_loss = (verb_loss + noun_loss + action_loss) / 3.0
                out_losses.update(loss_verb=verb_loss, loss_noun=noun_loss)
            out_losses.update(loss_action=action_loss,
                              loss_visual=visual_loss)
        if "audio" in cfg.data_modality:
            out_logits["audio"] = audio_l
            out_losses["loss_audio"] = ce(audio_l, batch["class_id"])
        return out_logits, out_losses

    return eval_step
