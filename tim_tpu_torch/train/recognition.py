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

Several processes (``parallel.mesh.Mesh``). JAX mixes the global
batch (``x[perm]`` reaches across devices) and divides each cross entropy
by the global batch's count of valid labels. Here each rank holds its rows
of the global batch: the step gathers the batch's inputs and label rows
from every rank (``all_gather``), encodes the global times, mixes the
global batch with the permutation drawn for it and keeps its own rows, so
that the time MLP's gradient through the mixed-in rows is taken where JAX
takes it; its loss is its share of the global loss (each cross entropy's
sum over its rows divided by the global count, the drloc mean weighted by
its share of the rows). The shares' gradients and the loss metrics are
summed over the ranks in one bucketed ``all_reduce`` before the
optimizer's clip and non-finite skip. The drloc positions, dropout masks
and the bank's augmentation sets are drawn for the global batch and
sliced. The eval step sums each cross entropy's sum and count over the
ranks (one ``all_reduce``) and divides. One process is a mesh of one
rank: the same code, whose collectives leave every value as it is.

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
from tim_tpu_torch.parallel.mesh import Mesh
from tim_tpu_torch.train.detection import (
    bank_generator, step_seeds, sum_loss_shares, with_bank_features)
from tim_tpu_torch.train.state import TrainState


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


# the batch keys a train step gathers from every rank
_GATHERED = ("times", "v_feats", "a_feats", "verb", "noun", "action",
             "class_id")


def _head_losses(logits, batch, full, start: int, perm, lam: float,
                 cfg: ModelConfig, tcfg: TrainConfig):
    """The mixup-weighted masked cross entropy of each head, this rank's
    share of the global batch ``full`` whose rows ``start:start + b`` are
    ``batch``: the mixed-in labels are the global rows ``perm[start:start
    + b]`` and each mean divides by the global batch's count. Returns
    (total, metrics)."""
    verb_l, noun_l, action_l, audio_l = logits

    def mix_ce(head_logits, key):
        labels = batch[key]
        mixed = full[key][perm]
        c = head_logits.shape[-1]
        return L.mixup_cross_entropy(
            _flat(head_logits), labels.reshape(-1),
            mixed[start:start + labels.shape[0]].reshape(-1), lam,
            label_smoothing=tcfg.label_smoothing,
            counts=(L.valid_labels(full[key], c).sum(),
                    L.valid_labels(mixed, c).sum()))

    out = {}
    device = batch["times"].device
    visual_loss = audio_loss = torch.zeros((), device=device)
    if "visual" in cfg.data_modality:
        action_loss = mix_ce(action_l, "action")
        if cfg.include_verb_noun:
            verb_loss = mix_ce(verb_l, "verb")
            noun_loss = mix_ce(noun_l, "noun")
            visual_loss = (verb_loss + noun_loss + action_loss) / 3.0
            out.update(loss_verb=verb_loss, loss_noun=noun_loss)
        else:
            visual_loss = action_loss
        out.update(loss_action=action_loss, loss_visual=visual_loss)
    if "audio" in cfg.data_modality:
        audio_loss = mix_ce(audio_l, "class_id")
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
                    draws: Optional[Callable[[int, int], StepDraws]] = None,
                    mesh=None):
    """Returns train_step(state, batch) -> metrics: time encoding, mixup,
    the forward with dropout, the head and drloc losses, backward, one
    optimizer update (``state.apply_gradients``).

    ``batch``: tensors on the model's device with the
    ``RecognitionDataset`` keys (``times``, ``v_feats``/``a_feats``, the
    label rows), this rank's rows of the global batch. ``draws`` (default
    ``make_step_draws``) makes the step's random draws. ``mesh``: the
    ``parallel.mesh.Mesh`` (default: the process group's; module
    docstring)."""
    draws = draws or make_step_draws(cfg, tcfg)
    mesh = mesh or model.mesh or Mesh()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        device = batch["times"].device
        b = batch["times"].shape[0]
        start, total_rows = mesh.rows(b)
        d = draws(state.step, total_rows)
        perm = host_to_device(d.perm, device)
        full = {k: mesh.all_gather(v) for k, v in batch.items()
                if k in _GATHERED}
        drloc = (None if d.drloc is None
                 else tuple(p[start:start + b] for p in d.drloc))
        inputs = [full[k] for k, mod in (("v_feats", "visual"),
                                         ("a_feats", "audio"))
                  if mod in cfg.input_modality]
        *feats, te = [x[start:start + b] for x in L.mixup(
            inputs + [model.encode_times(full["times"])], perm, d.lam)]
        v = feats[0] if "visual" in cfg.input_modality else None
        a = feats[-1] if "audio" in cfg.input_modality else None
        logits, ctx = model.encoder_forward(
            v, a, te, num_v_queries, num_a_queries,
            dropout_seed=d.dropout_seed, dropout_rows=(start, total_rows))
        total, metrics = _head_losses(logits, batch, full, start, perm,
                                      d.lam, cfg, tcfg)
        # this rank's share of the global mean
        dr = _drloc(drloc, ctx, model, cfg, tcfg) * (b / total_rows)
        total = total + tcfg.lambda_drloc * dr
        metrics["loss_drloc"] = dr
        metrics["loss"] = total
        total.backward()
        metrics = sum_loss_shares(mesh, model, {k: v.detach()
                                                for k, v in metrics.items()})
        metrics["grad_norm"] = state.apply_gradients()
        return metrics

    return train_step


def make_bank_train_step(model: TimRecognition, cfg: ModelConfig,
                         tcfg: TrainConfig, num_v_queries: int,
                         num_a_queries: int, v_bank=None, a_bank=None,
                         draws: Optional[Callable] = None, mesh=None):
    """The train step on features gathered from device-resident banks:
    the batch carries ``feat_indices`` [B, F] (``data.device_bank.
    DeviceWindowTables``) in place of the features; one augmentation set
    per token comes from a CPU generator seeded by
    ``step_seeds(tcfg.seed, step, 11)`` (``train.detection.
    bank_generator``)."""
    mesh = mesh or model.mesh or Mesh()
    base = make_train_step(model, cfg, tcfg, num_v_queries, num_a_queries,
                           draws, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        gen = bank_generator(tcfg.seed, state.step, batch, mesh)
        return base(state, with_bank_features(batch, v_bank, a_bank, gen))

    return step


def make_eval_step(model: TimRecognition, cfg: ModelConfig,
                   tcfg: TrainConfig, num_v_queries: int,
                   num_a_queries: int, mesh=None):
    """Returns eval_step(batch) -> (logits, losses): the raw logits [B, Nq,
    C] of each head (in the compute dtype, for the window-vote ensemble)
    and the cross entropy of each head, from the deterministic forward
    (kernel 1 on the card). The logits are this rank's rows, and each
    cross entropy is the global batch's: the ranks' sums and valid-label
    counts summed (one ``all_reduce``), divided. ``mesh``: as
    ``make_train_step``'s."""
    mesh = mesh or model.mesh or Mesh()

    def cross_entropies(heads, batch):
        """The cross entropy of each (label key, logits) of ``heads``."""
        flat = [(_flat(logits), batch[key].reshape(-1))
                for key, logits in heads]
        sums = torch.stack([L.cross_entropy(
            x, y, label_smoothing=tcfg.label_smoothing, reduction="sum")
            for x, y in flat])
        counts = torch.stack([L.valid_labels(y, x.shape[-1]).sum()
                              for x, y in flat]).float()
        total = mesh.all_reduce_sum(torch.cat([sums, counts]))
        n = len(flat)
        return list(total[:n] / torch.clamp(total[n:], min=1))

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]):
        (verb_l, noun_l, action_l, audio_l), _ = model(
            batch.get("v_feats"), batch.get("a_feats"), batch["times"],
            num_v_queries, num_a_queries)
        heads = {}           # label key -> (output name, logits)
        if "visual" in cfg.data_modality:
            heads["action"] = ("action", action_l)
            if cfg.include_verb_noun:
                heads["verb"] = ("verb", verb_l)
                heads["noun"] = ("noun", noun_l)
        if "audio" in cfg.data_modality:
            heads["class_id"] = ("audio", audio_l)
        ce = dict(zip(heads, cross_entropies(
            [(key, logits) for key, (_, logits) in heads.items()], batch)))
        out_logits = {name: logits for name, logits in heads.values()}
        out_losses = {}
        if "visual" in cfg.data_modality:
            visual_loss = ce["action"]
            if cfg.include_verb_noun:
                visual_loss = (ce["verb"] + ce["noun"] + ce["action"]) / 3.0
                out_losses.update(loss_verb=ce["verb"], loss_noun=ce["noun"])
            out_losses.update(loss_action=ce["action"],
                              loss_visual=visual_loss)
        if "audio" in cfg.data_modality:
            out_losses["loss_audio"] = ce["class_id"]
        return out_logits, out_losses

    return eval_step
