"""Detection train, validation and inference steps: counterpart of
``tim_tpu/train/detection.py``.

Pyramid sampling, IoU labelling, focal + DIoU losses with the EMA
positive-count normaliser (``TrainState.normaliser``, advanced by the
train step and never by the validation step), drloc, backward and the
optimizer update. A step reads nothing back to the host: its metrics are
0-d device tensors.

Randomness. Every draw of a step derives from ``(TrainConfig.seed,
step)`` (``step_seeds``), so a resumed run draws what an uninterrupted
one would. The small draws (the two query permutations, the drloc
positions, the bank's augmentation sets) come from a CPU
``torch.Generator`` and are then moved to the device, so that the card
and the CPU draw the same ones; the dropout masks come from device
generators seeded from the step's ``dropout_seed`` (``models.tim``). All
of a step's draws are made by one function (``make_step_draws``), which
``make_train_step`` takes as an argument.

Several processes (``parallel.mesh.Mesh``). JAX runs one program
over the global batch, so its counts are global; here each rank holds its
rows of the global batch and its loss is its share of the global loss:
the positive counts of both modalities are summed over the ranks (one
``all_reduce``) before the EMA normaliser, which therefore stays the same
on every rank, and the focal and DIoU sums of the rank's rows divide by
it; the drloc mean is weighted by the rank's share of the rows. The
shares' gradients and the loss metrics are then summed over the ranks in
one bucketed ``all_reduce`` (``Mesh.sync_gradients``) before the
optimizer's clip and non-finite skip. The draws are those of the global
batch: the drloc positions are drawn for it and sliced, the dropout masks
and the bank's augmentation sets drawn at its shape
(``ops.dropout.BatchRows``). The validation step sums its loss shares
over the ranks. One process is a mesh of one rank: the same code, whose
collectives leave every value as it is.

Kernels. The train step runs the model with dropout (``deterministic``
false), so it never reaches kernel 1 (query-block attention) or kernel 2
(the fused tail), as in JAX; the validation and inference steps are
deterministic and reach them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tim_tpu_torch.config import DetectionConfig, TrainConfig
from tim_tpu_torch.data.device_bank import gather_window_batch, host_to_device
from tim_tpu_torch.models import queries as Q
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.models.tim import TimDetection
from tim_tpu_torch.ops import losses as L
from tim_tpu_torch.ops.dropout import BatchRows
from tim_tpu_torch.parallel.mesh import Mesh
from tim_tpu_torch.train.state import TrainState


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _modality_losses(cls_logits, reg_preds, targets, labels, ious,
                     cfg: DetectionConfig, tcfg: TrainConfig, normaliser,
                     modality: str, *, update_normaliser: bool = True,
                     num_pos=None):
    """Focal cls (IoU-weighted) + DIoU reg for one modality. Returns
    (cls_loss, reg_loss, new_normaliser, num_pos).
    ``update_normaliser=False`` divides by the incoming value unchanged
    (the reference's validation takes a fixed normaliser). ``num_pos``:
    the global batch's positive count (several processes), else this
    batch's."""
    flat_targets = _flat(targets)
    flat_ious = ious.reshape(-1)
    positives = torch.isfinite(flat_targets[:, 0])
    if num_pos is None:
        num_pos = positives.sum()

    if update_normaliser:
        # EMA normaliser of the positive count
        normaliser = (tcfg.normaliser_momentum * normaliser
                      + (1.0 - tcfg.normaliser_momentum)
                      * torch.clamp(num_pos.float(), min=1.0))

    # queries below the IoU threshold weigh 1.0, positives their IoU
    w = torch.where(flat_ious < cfg.iou_threshold, 1.0, flat_ious)

    def focal_sum(logits, int_labels):
        return L.sigmoid_focal_loss_smoothed(
            _flat(logits), int_labels, cfg.label_smoothing,
            alpha=tcfg.focal_alpha, gamma=tcfg.focal_gamma, weights=w)

    flat_labels = _flat(labels)
    if modality == "visual":
        if len(cfg.visual_classes) == 3:
            cls_loss = (focal_sum(cls_logits[0], flat_labels[:, 0])
                        + focal_sum(cls_logits[1], flat_labels[:, 1])
                        + focal_sum(cls_logits[2], flat_labels[:, 2])) / 3.0
        else:
            cls_loss = focal_sum(cls_logits[2], flat_labels[:, -1])
    else:
        cls_loss = focal_sum(cls_logits[3], flat_labels[:, -1])
    cls_loss = cls_loss / normaliser

    # DIoU on positives only; the inf targets zeroed through the mask
    safe_targets = torch.where(positives[:, None], flat_targets, 0.0)
    reg_per = L.ctr_diou_loss_1d(_flat(reg_preds), safe_targets)
    reg_loss = (torch.sum(reg_per * positives) * tcfg.lambda_reg) / normaliser
    return cls_loss, reg_loss, normaliser, num_pos


def step_seeds(seed: int, step: int, *salt: int) -> Tuple[int, int]:
    """Two seeds derived from (seed, step, *salt): one for the step's CPU
    generator, one for its dropout (below 2**62, so that the per-layer
    seeds ``dropout_seed + 1 + i`` stay in range)."""
    a, b = np.random.SeedSequence([seed, step, *salt]).generate_state(
        2, np.uint64)
    return int(a) >> 1, int(b) >> 2


@dataclass
class StepDraws:
    """A train step's random draws, on the CPU: the shared visual and
    audio queries [nq, 2] (None for an absent modality), the drloc
    position pair [B, m] (None without drloc), the dropout seed."""

    v_queries: Optional[torch.Tensor]
    a_queries: Optional[torch.Tensor]
    drloc: Optional[Tuple[torch.Tensor, torch.Tensor]]
    dropout_seed: int


def make_step_draws(cfg: DetectionConfig, tcfg: TrainConfig,
                    num_queries: int) -> Callable[[int, int], StepDraws]:
    """draws(step, batch_size) -> StepDraws, from a CPU generator seeded
    by ``step_seeds(tcfg.seed, step)``: visual queries, audio queries,
    drloc positions, in that order."""
    pool = torch.from_numpy(generate_query_pyramid(cfg.train_query_size))

    def draws(step: int, batch_size: int) -> StepDraws:
        cpu_seed, dropout_seed = step_seeds(tcfg.seed, step)
        gen = torch.Generator().manual_seed(cpu_seed)
        v = a = drloc = None
        if "visual" in cfg.data_modality:
            v = Q.sample_train_queries(gen, pool, num_queries)
        if "audio" in cfg.data_modality:
            a = Q.sample_train_queries(gen, pool, num_queries)
        if tcfg.lambda_drloc > 0.0:
            drloc = L.drloc_positions(gen, batch_size, cfg.num_feats,
                                      tcfg.m_drloc)
        return StepDraws(v, a, drloc, dropout_seed)

    return draws


def _visual_labels(batch, cfg):
    if len(cfg.visual_classes) == 3:
        return torch.stack([batch["verb"], batch["noun"], batch["action"]],
                           dim=-1)
    return batch["action"][..., None]


def _detection_losses(cls_logits, reg_preds, v_queries, a_queries, batch,
                      cfg, tcfg, normaliser, update_normaliser: bool,
                      mesh: Mesh):
    """Labels the queries and sums the modalities' losses. Returns
    (total, metrics, normaliser). With ``update_normaliser`` the positive
    counts are the global batch's (summed over ``mesh``)."""
    labelled = []
    if v_queries is not None:
        labelled.append(("visual", reg_preds[0], Q.label_queries(
            v_queries, batch["v_gt_segments"], _visual_labels(batch, cfg),
            cfg.iou_threshold)))
    if a_queries is not None:
        labelled.append(("audio", reg_preds[1], Q.label_queries(
            a_queries, batch["a_gt_segments"], batch["class_id"][..., None],
            cfg.iou_threshold)))
    counts = [None] * len(labelled)
    if update_normaliser:
        counts = list(mesh.all_reduce_sum(torch.stack([
            torch.isfinite(_flat(targets)[:, 0]).sum()
            for _, _, (targets, _, _) in labelled])))

    metrics = {}
    total = torch.zeros((), device=batch["times"].device)
    norm = normaliser
    for (modality, preds, (targets, labels, ious)), count in zip(labelled,
                                                                  counts):
        cls, reg, norm, pos = _modality_losses(
            cls_logits, preds, targets, labels, ious, cfg, tcfg, norm,
            modality, update_normaliser=update_normaliser, num_pos=count)
        metrics.update({f"loss_{modality}": cls,
                        f"loss_{modality}_reg": reg})
        if update_normaliser:
            metrics[f"num_pos_{modality}"] = pos
        scale = (tcfg.lambda_audio if modality == "audio"
                 and v_queries is not None else 1.0)
        total = total + scale * (cls + reg)
    return total, metrics, norm


def sum_loss_shares(mesh, model, metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``metrics`` with each ``loss*`` share summed over the data ranks,
    in the one ``all_reduce`` that sums the parameters' gradients; under
    sequence parallelism the gradients that the model ranks' token shards
    left partial are summed over the model group first."""
    mesh.sum_model_gradients(model.encoder.token_partial_parameters())
    keys = [k for k in metrics if k.startswith("loss")]
    summed = mesh.sync_gradients(list(model.parameters()),
                                 [metrics[k] for k in keys])
    return {**metrics, **dict(zip(keys, summed))}


def make_train_step(model: TimDetection, cfg: DetectionConfig,
                    tcfg: TrainConfig, num_queries: Optional[int] = None,
                    draws: Optional[Callable[[int, int], StepDraws]] = None,
                    mesh=None):
    """Returns train_step(state, batch) -> metrics: forward with dropout,
    losses, backward, one optimizer update (``state.apply_gradients``).

    ``batch``: tensors on the model's device, the ``DetectionDataset``
    keys. Each step samples ``num_queries`` (default: the inference grid's
    size) of the fine train pool, shared across the batch. ``draws``
    (default ``make_step_draws``) makes the step's random draws.
    ``batch`` is this rank's rows of the global batch; ``mesh``: the
    ``parallel.mesh.Mesh`` (default: the process group's; module
    docstring)."""
    if num_queries is None:
        num_queries = generate_query_pyramid(
            cfg.inference_query_size).shape[0]
    draws = draws or make_step_draws(cfg, tcfg, num_queries)
    mesh = mesh or model.mesh or Mesh()
    nv = num_queries if "visual" in cfg.data_modality else 0
    na = num_queries if "audio" in cfg.data_modality else 0
    nf = cfg.num_feats

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        device = batch["times"].device
        b = batch["times"].shape[0]
        start, total_rows = mesh.rows(b)
        d = draws(state.step, total_rows)
        drloc = (None if d.drloc is None
                 else tuple(p[start:start + b] for p in d.drloc))
        qs = [None if q is None else host_to_device(q, device)
              for q in (d.v_queries, d.a_queries)]

        # the shared queries go through the time MLP once, then broadcast
        te = [model.encode_times(batch["times"])]
        for q in qs:
            if q is not None:
                te.append(model.encode_times(q[None]).expand(b, -1, -1))
        cls_logits, reg_preds, ctx = model.encoder_forward(
            batch.get("v_feats"), batch.get("a_feats"), torch.cat(te, 1),
            nv, na, dropout_seed=d.dropout_seed,
            dropout_rows=(start, total_rows))
        total, metrics, norm = _detection_losses(
            cls_logits, reg_preds,
            *[None if q is None else q[None].expand(b, -1, -1) for q in qs],
            batch, cfg, tcfg, state.normaliser, True, mesh)

        if tcfg.lambda_drloc > 0.0:
            pairs = ((ctx[:, :nf], ctx[:, nf:2 * nf])
                     if cfg.input_modality == "audio_visual" else (ctx, ctx))
            # this rank's share of the global mean
            dr = L.drloc_loss(drloc, *pairs, model.drloc) * (b / total_rows)
            total = total + tcfg.lambda_drloc * dr
            metrics["loss_drloc"] = dr
        metrics["loss"] = total
        total.backward()
        norm = norm.detach()
        metrics = sum_loss_shares(mesh, model, {k: v.detach()
                                                for k, v in metrics.items()})
        metrics["grad_norm"] = state.apply_gradients(normaliser=norm)
        metrics["normaliser"] = norm
        return metrics

    return train_step


def with_bank_features(batch: Dict[str, torch.Tensor], v_bank, a_bank,
                       generator: Optional[torch.Generator] = None):
    """``batch`` with its ``feat_indices`` [B, F] replaced by the features
    gathered from the device banks (``gather_window_batch``: one
    augmentation set per token from ``generator``, else set 0)."""
    v, a = gather_window_batch(v_bank, a_bank, batch["feat_indices"],
                               generator=generator)
    full = {k: t for k, t in batch.items() if k != "feat_indices"}
    if v is not None:
        full["v_feats"] = v
    if a is not None:
        full["a_feats"] = a
    return full


def bank_generator(seed: int, step: int, batch: Dict[str, torch.Tensor],
                   mesh: Mesh):
    """The CPU generator of a banked step's augmentation sets, seeded by
    ``step_seeds(seed, step, 11)``: it draws the global batch's sets and
    keeps this rank's rows."""
    gen = torch.Generator().manual_seed(step_seeds(seed, step, 11)[0])
    return BatchRows(gen, *mesh.rows(batch["feat_indices"].shape[0]))


def make_bank_train_step(model: TimDetection, cfg: DetectionConfig,
                         tcfg: TrainConfig, v_bank=None, a_bank=None,
                         num_queries: Optional[int] = None,
                         draws: Optional[Callable] = None, mesh=None):
    """The train step on features gathered from device-resident banks:
    the batch carries ``feat_indices`` [B, F] (``data.device_bank.
    DetectionWindowTables``) in place of the features; one augmentation
    set per token comes from a CPU generator seeded by
    ``step_seeds(tcfg.seed, step, 11)`` (``bank_generator``)."""
    mesh = mesh or model.mesh or Mesh()
    base = make_train_step(model, cfg, tcfg, num_queries, draws, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        gen = bank_generator(tcfg.seed, state.step, batch, mesh)
        return base(state, with_bank_features(batch, v_bank, a_bank, gen))

    return step


def _grid_forward(model, grid, batch, nv, na):
    """The deterministic forward over the fixed query grid, encoded once
    and broadcast: (cls logits, reg preds)."""
    b = batch["times"].shape[0]
    te_query = model.encode_times(grid[None]).expand(b, -1, -1)
    te = torch.cat([model.encode_times(batch["times"])]
                   + [te_query] * ((nv > 0) + (na > 0)), dim=1)
    cls_logits, reg_preds, _ = model.encoder_forward(
        batch.get("v_feats"), batch.get("a_feats"), te, nv, na,
        shared_queries=True)
    return cls_logits, reg_preds


def make_val_step(model: TimDetection, cfg: DetectionConfig,
                  tcfg: TrainConfig, mesh=None):
    """Returns val_step(state, batch) -> metrics: the losses on the fixed
    inference grid, deterministic (no dropout; kernel 1 on the card). The
    normaliser is read from the state, not advanced. The ranks' loss
    shares are summed over ``mesh`` (one ``all_reduce``; default: the
    process group's)."""
    mesh = mesh or model.mesh or Mesh()
    device = next(model.parameters()).device
    grid = torch.from_numpy(
        generate_query_pyramid(cfg.inference_query_size)).to(device)
    nq = grid.shape[0]
    nv = nq if "visual" in cfg.data_modality else 0
    na = nq if "audio" in cfg.data_modality else 0

    @torch.inference_mode()
    def val_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        cls_logits, reg_preds = _grid_forward(model, grid, batch, nv, na)
        queries = grid[None].expand(batch["times"].shape[0], -1, -1)
        total, metrics, _ = _detection_losses(
            cls_logits, reg_preds, queries if nv else None,
            queries if na else None, batch, cfg, tcfg, state.normaliser,
            False, mesh)
        metrics["loss"] = total
        summed = mesh.all_reduce_sum(torch.stack(list(metrics.values())))
        return dict(zip(metrics, summed))

    return val_step


def make_inference_step(model: TimDetection, cfg: DetectionConfig,
                        top_k: Optional[int] = None):
    """Returns ``infer_step(batch) -> dict`` with per-query sigmoid scores
    and proposals denormalised to video time (``clamp(reg) * win_size +
    win_start``), the dense extraction dump.

    ``batch``: tensors on the model's device -- ``times`` [B, num_ctx, 2],
    ``v_feats``/``a_feats`` [B, F, D] per input modality, ``window_start``
    and ``window_size`` [B].

    ``top_k``: emit only the k best classes per query as
    ``<head>_topk_values`` / ``<head>_topk_classes`` instead of the dense
    [B, Nq, C] score matrices."""
    device = next(model.parameters()).device
    grid = torch.from_numpy(
        generate_query_pyramid(cfg.inference_query_size)).to(device)
    nq = grid.shape[0]
    has_visual = "visual" in cfg.data_modality
    has_audio = "audio" in cfg.data_modality
    nv = nq if has_visual else 0
    na = nq if has_audio else 0

    @torch.inference_mode()
    def infer_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cls_logits, reg_preds = _grid_forward(model, grid, batch, nv, na)
        win_start = batch["window_start"][:, None, None]
        win_size = batch["window_size"][:, None, None]

        def scores_out(out, name, logits):
            probs = torch.sigmoid(logits.float())
            if top_k is None:
                out[name] = probs
                return
            vals, idx = torch.topk(probs, min(top_k, probs.shape[-1]), dim=-1)
            base = name.split("_")[0]
            out[f"{base}_topk_values"] = vals
            out[f"{base}_topk_classes"] = idx.to(torch.int32)

        out = {"queries": grid[None] * win_size + win_start}
        if has_visual:
            scores_out(out, "v_scores", cls_logits[2])
            if len(cfg.visual_classes) == 3:
                scores_out(out, "verb_scores", cls_logits[0])
                scores_out(out, "noun_scores", cls_logits[1])
            out["v_proposals"] = (reg_preds[0].float().clamp(0.0, 1.0)
                                  * win_size + win_start)
        if has_audio:
            scores_out(out, "a_scores", cls_logits[3])
            out["a_proposals"] = (reg_preds[1].float().clamp(0.0, 1.0)
                                  * win_size + win_start)
        return out

    return infer_step
