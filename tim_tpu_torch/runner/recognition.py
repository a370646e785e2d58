"""Recognition training, validation and prediction dumps, one card a
process: counterpart of ``tim_tpu/runner/recognition.py``.

``RecognitionRunner`` builds a ``TimRecognition`` on its device (the CUDA
card unless ``device="cpu"`` is asked for; without a card it raises),
trains it with ``train.recognition.make_train_step`` and the TIM
optimizer, validates with ``make_eval_step`` (deterministic: kernel 1 on
the card) by window-vote ensembling (``evals.meters.
WindowVoteAccumulator``: each GT action's logits summed over the windows
that hold it, normalised by the count, softmaxed), keeps the best models
by top-1 accuracy and writes checkpoints (``train.checkpoint``). Two data
paths, as in JAX:

- host: ``batch_iterator`` over a ``RecognitionDataset`` (numpy), each
  batch moved to the device, its logits read back and voted on the host;
- banked (``use_device_bank``): the whole split on the device
  (``DeviceFeatureBank``, ``DeviceWindowTables``), a batch a tensor of
  window ids. Validation sums the votes on the device, in float64, and
  reads them back once. JAX adds them with a scatter-add; the port sums
  each batch's rows per action with a one-hot product (which rows go to
  which action is known on the host beforehand), so that no float
  atomics make two validations differ.

Several processes (``parallel.multihost.initialize``, one card each):
the runner's ``Mesh`` splits every global batch of ``batch_size``
windows into equal rank shares. On the host path each rank iterates its
shard of the split (``batch_iterator(num_shards=, shard_index=)``, JAX's
wrap-around padding included) and, after validation, the ranks'
accumulators are merged (``reduce_across_processes``). On the banked path
every card holds the whole bank, every rank draws the same window order
and takes its slice of each batch of ids; validation sums the ranks' vote
tables on the device (one float64 ``all_reduce``) and counts the votes
and labels from the host tables. The steps sum the ranks' shares of the
global loss (``train.recognition``). Rank 0 writes the checkpoints and
dumps and logs; every rank reads ``resume``.

The log line of every ``print_freq``-th step carries the iteration's,
data's and step's seconds (``utils.logging.PhaseTimer``) and
``utils.memory.memory_summary``, as JAX's host path logs them.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tim_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from tim_tpu_torch.data.dataset import (
    RecognitionDataset, batch_iterator, pad_rows)
from tim_tpu_torch.data.device_bank import (
    DeviceFeatureBank, DeviceWindowTables, host_to_device)
from tim_tpu_torch.evals.meters import LossAverager, WindowVoteAccumulator
from tim_tpu_torch.models.tim import TimRecognition, resolve_device
from tim_tpu_torch.parallel import multihost
from tim_tpu_torch.parallel.mesh import make_mesh, shard_train_state
from tim_tpu_torch.train import checkpoint as ckpt
from tim_tpu_torch.train import recognition as steps
from tim_tpu_torch.train.detection import with_bank_features
from tim_tpu_torch.train.optim import make_optimizer
from tim_tpu_torch.train.state import TrainState, create_train_state
from tim_tpu_torch.utils.logging import (
    PhaseTimer, log_json_stats, setup_logging)
from tim_tpu_torch.utils.memory import memory_summary

_VISUAL_HEADS = ("verb", "noun", "action")


def _head_spec(cfg: ModelConfig) -> Dict[str, int]:
    heads = {}
    if "visual" in cfg.data_modality:
        if cfg.include_verb_noun:
            heads["verb"] = cfg.visual_classes[0]
            heads["noun"] = cfg.visual_classes[1]
        heads["action"] = cfg.visual_classes[-1]
    if "audio" in cfg.data_modality:
        heads["audio"] = cfg.audio_classes
    return heads


def _tables(ds: RecognitionDataset, device) -> tuple:
    """(v_bank, a_bank, DeviceWindowTables) of a split on ``device``."""
    v_bank = (DeviceFeatureBank(ds.visual.feats, device=device)
              if ds.visual is not None else None)
    a_bank = (DeviceFeatureBank(ds.audio.feats, device=device)
              if ds.audio is not None else None)
    tables = DeviceWindowTables(
        ds.windows, v_bank, a_bank,
        ds.visual.feat_times if ds.visual is not None else None,
        ds.audio.feat_times if ds.audio is not None else None)
    return v_bank, a_bank, tables


class _VotePlan:
    """Which logit rows of each validation batch vote for which action,
    worked out on the host once: the batches are the window-id ranges of
    the split, the last one padded with its first window (whose rows do
    not vote). A batch's votes are then ``sel @ logits`` ([U, R] one-hot
    x [R, C], float64: exact products, fixed order), added to the U
    distinct actions' rows."""

    def __init__(self, ids_table: np.ndarray, n: int, bs: int, device,
                 share: slice = slice(None)):
        """``share``: this rank's rows of each batch."""
        self.device = device
        self.batches: List[np.ndarray] = []
        self.groups = []       # per batch: (actions [U], row -> group [R])
        for start in range(0, n, bs):
            chunk = np.arange(start, min(start + bs, n))
            take = len(chunk)
            chunk = np.concatenate([chunk, np.full(bs - take, chunk[0])])
            self.batches.append(chunk[share])
            if ids_table is None:
                continue
            rows = ids_table[chunk].copy()
            rows[take:] = -1
            rows = rows[share]
            flat = rows.reshape(-1)
            ok = flat >= 0
            actions, inverse = np.unique(flat[ok], return_inverse=True)
            group = np.full(flat.shape, len(actions), np.int64)
            group[ok] = inverse
            self.groups.append((actions, group))

    def add(self, sums: torch.Tensor, logits: torch.Tensor, k: int) -> None:
        """Add batch ``k``'s logits [B, Nq, C] into ``sums`` [A, C]."""
        actions, group = self.groups[k]
        if not len(actions):
            return
        sel = F.one_hot(host_to_device(torch.from_numpy(group), self.device),
                        len(actions) + 1)[:, :len(actions)].t().double()
        rows = host_to_device(torch.from_numpy(actions), self.device)
        flat = logits.reshape(-1, logits.shape[-1]).double()
        sums[rows] = sums[rows] + sel @ flat


class RecognitionRunner:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        train_ds: Optional[RecognitionDataset],
        val_ds: Optional[RecognitionDataset],
        *,
        mesh_cfg: MeshConfig = MeshConfig(),
        output_dir: Optional[str] = None,
        dataset_name: str = "epic",
        print_freq: int = 100,
        use_device_bank: bool = False,
        experiment_logger=None,
        device: Optional[torch.device | str] = None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.output_dir = output_dir
        self.dataset_name = dataset_name
        self.print_freq = print_freq
        self.logger = setup_logging(output_dir)
        self.exp_logger = experiment_logger
        self.device = resolve_device(device)

        ws = (train_ds or val_ds).windows
        self.nv = ws.max_visual_actions
        self.na = ws.max_audio_actions
        self.mesh = mesh = make_mesh(mesh_cfg.data, mesh_cfg.model)
        self.model = TimRecognition(
            cfg, device=self.device,
            generator=torch.Generator().manual_seed(tcfg.seed), mesh=mesh)
        self.steps_per_epoch = (max(len(train_ds) // tcfg.batch_size, 1)
                                if train_ds else 1)
        self._local_bs = mesh.local_batch(tcfg.batch_size)
        self._share = mesh.share(tcfg.batch_size)
        self._shard_args = mesh.shard_args
        self._train_step = steps.make_train_step(self.model, cfg, tcfg,
                                                 self.nv, self.na, mesh=mesh)
        self._eval_step = steps.make_eval_step(self.model, cfg, tcfg,
                                               self.nv, self.na, mesh=mesh)

        self._bank_step = self._val_banks = None
        if use_device_bank and train_ds is not None:
            v_bank, a_bank, self._tables = _tables(train_ds, self.device)
            self._bank_step = steps.make_bank_train_step(
                self.model, cfg, tcfg, self.nv, self.na, v_bank, a_bank,
                mesh=mesh)
        if use_device_bank and val_ds is not None:
            ws_val = val_ds.windows
            if (ws_val.max_visual_actions, ws_val.max_audio_actions) != (
                    self.nv, self.na):
                raise ValueError(
                    "banked validation needs the validation split's query "
                    "maxima to match the eval step's shapes")
            self._val_banks = _tables(val_ds, self.device)
            n, bs = len(ws_val.windows), tcfg.batch_size
            # the vote ids of each window, by the queries the model answers
            self._val_v_ids = (np.stack([
                pad_rows(w.v_action_ids, self.nv, -1, np.int64)
                for w in ws_val.windows])
                if "visual" in cfg.data_modality and self.nv > 0 else None)
            self._val_a_ids = (np.stack([
                pad_rows(w.a_action_ids, self.na, -1, np.int64)
                for w in ws_val.windows])
                if "audio" in cfg.data_modality and self.na > 0 else None)
            self._v_plan = _VotePlan(self._val_v_ids, n, bs, self.device,
                                     self._share)
            self._a_plan = _VotePlan(self._val_a_ids, n, bs, self.device,
                                     self._share)

        self.state: Optional[TrainState] = None
        self.best = {"visual": 0.0, "visual_mt": 0.0, "audio": 0.0,
                     "combined": 0.0}
        self.last_best_epoch = 0

    # ------------------------------------------------------------------
    def init_state(self, pretrained: Optional[str] = None) -> TrainState:
        """The optimizer over the model's parameters, after merging the
        shape-matched parameters of the checkpoint at ``pretrained`` (a
        ``.pt`` or the JAX package's msgpack or orbax checkpoint) into the
        model."""
        if pretrained:
            ckpt.merge_params(self.model,
                              ckpt.load_checkpoint(pretrained)["params"])
        tcfg = self.tcfg
        optimizer = make_optimizer(
            self.model.parameters(), tcfg.lr, tcfg.weight_decay,
            total_steps=self.steps_per_epoch * tcfg.epochs,
            warmup_steps=self.steps_per_epoch * tcfg.warmup_epochs,
            min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm)
        self.state = shard_train_state(
            create_train_state(self.model, optimizer), self.mesh)
        return self.state

    def resume(self, path: str) -> int:
        """Full training resume (parameters, optimizer, step) from a
        ``.pt`` or the JAX package's msgpack or orbax checkpoint; returns
        the epoch to continue from. Every rank reads the checkpoint."""
        if self.state is None:
            self.init_state()
        payload = ckpt.load_checkpoint(path)
        shard_train_state(ckpt.restore_train_state(self.state, payload),
                          self.mesh)
        return int(payload.get("epoch", 0))

    def load_torch_checkpoint(self, state_dict: Mapping[str, torch.Tensor]
                              ) -> TrainState:
        """Load a released reference recognition checkpoint's state dict
        (the port uses its parameter names) strictly."""
        if self.state is None:
            self.init_state()
        self.model.load_state_dict(state_dict, strict=True)
        return shard_train_state(self.state, self.mesh)

    # ------------------------------------------------------------------
    def _to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: host_to_device(torch.from_numpy(np.asarray(v)),
                                  self.device)
                for k, v in batch.items()
                if not k.startswith("_")
                and k not in ("v_action_ids", "a_action_ids")}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch, shuffled by a generator seeded ``seed + epoch``; the
        metrics of every ``print_freq``-th step are read back, logged with
        the phase times and memory, and averaged."""
        if self.state is None:
            self.init_state()
        avg = LossAverager()
        epoch_rng = np.random.default_rng(self.tcfg.seed + epoch)
        bs = self.tcfg.batch_size
        if self._bank_step is not None:
            # the same order on every rank, each taking its share
            order = epoch_rng.permutation(self._tables.num_windows)
            batches = (self._tables.batch(host_to_device(
                torch.from_numpy(order[i:i + bs][self._share]), self.device))
                for i in range(0, len(order) - bs + 1, bs))
            step, tag = self._bank_step, " (banked)"
        else:
            batches = (self._to_device(b) for b in batch_iterator(
                self.train_ds, self._local_bs, shuffle=True, rng=epoch_rng,
                **self._shard_args))
            step, tag = self._train_step, ""
        timer = PhaseTimer()
        timer.iter_tic()
        for i, batch in enumerate(batches):
            timer.data_toc()
            metrics = step(self.state, batch)
            if i % self.print_freq == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                timer.net_toc()
                timer.iter_toc()
                avg.update(metrics)
                self.logger.info(
                    "epoch %d iter %d | loss %.4f | iter %.3fs (data %.3fs "
                    "net %.3fs) | %s%s", epoch + 1, i, metrics["loss"],
                    timer.iter_time, timer.data_time, timer.net_time,
                    memory_summary(self.device), tag)
            timer.iter_tic()
        return self._log(avg.averages(), "train", epoch)

    def _log(self, stats: Dict[str, float], split: str, epoch: int
             ) -> Dict[str, float]:
        log_json_stats(self.logger, {"split": split, "epoch": epoch + 1,
                                     **stats})
        if self.exp_logger is not None:
            self.exp_logger.log({f"{split}/{k}": v for k, v in stats.items()})
        return stats

    # ------------------------------------------------------------------
    def _run_bank_accum(self, acc: WindowVoteAccumulator,
                        avg: Optional[LossAverager] = None) -> None:
        """The whole validation split on the device: an eval step per
        window-id range, the votes summed per action in float64 and the
        losses summed, all read back once. The last range repeats its
        first window (as ``batch_iterator`` pads), its rows kept out of
        the votes."""
        v_bank, a_bank, tables = self._val_banks
        sums = {h: torch.zeros((acc.num_actions, c), dtype=torch.float64,
                               device=self.device)
                for h, c in _head_spec(self.cfg).items()}
        loss_sum: Dict[str, torch.Tensor] = {}
        batches = self._v_plan.batches
        for k, ids in enumerate(batches):
            batch = with_bank_features(tables.batch(host_to_device(
                torch.from_numpy(ids), self.device)), v_bank, a_bank)
            logits, losses = self._eval_step(batch)
            if self._val_v_ids is not None:
                for h in _VISUAL_HEADS:
                    if h in sums and h in logits:
                        self._v_plan.add(sums[h], logits[h], k)
            if self._val_a_ids is not None and "audio" in sums:
                self._a_plan.add(sums["audio"], logits["audio"], k)
            for key, val in losses.items():
                loss_sum[key] = loss_sum.get(key, 0.0) + val.float()
        # every rank voted with its rows: one float64 sum over the ranks
        flat = self.mesh.all_reduce_sum(
            torch.cat([s.reshape(-1) for s in sums.values()]))
        for (h, s), piece in zip(sums.items(), flat.split(
                [s.numel() for s in sums.values()])):
            acc.sums[h] += piece.view(s.shape).cpu().numpy()
        # the counts and labels are known on the host, from the tables
        for ids, col in ((self._val_v_ids, None), (self._val_a_ids, 3)):
            if ids is None or (col == 3 and "audio" not in sums):
                continue
            flat = ids.reshape(-1)
            ok = flat >= 0
            np.add.at(acc.seen, flat[ok], 1.0)
            if col is None:
                for c, key in enumerate(_VISUAL_HEADS):
                    acc.v_labels[flat[ok], c] = \
                        tables.labels_host[key].reshape(-1)[ok]
            else:
                acc.a_labels[flat[ok]] = \
                    tables.labels_host["class_id"].reshape(-1)[ok]
        if avg is not None and loss_sum:
            host = torch.stack(list(loss_sum.values())).cpu().tolist()
            avg.update({k: s / len(batches) for k, s in zip(loss_sum, host)})

    def _eval_batches(self, ds: RecognitionDataset):
        """(logits, losses, v_ids, a_ids, labels) per eval batch on the
        host path, each row of the batch's padded tail left out."""
        ds.sample_augmentations = False
        bs = self._local_bs
        for batch in batch_iterator(ds, bs, shuffle=False, drop_last=False,
                                    **self._shard_args):
            take = bs - batch["_pad"]
            logits, losses = self._eval_step(self._to_device(batch))
            yield ({k: v[:take].float().cpu().numpy()
                    for k, v in logits.items()},
                   losses,
                   batch["v_action_ids"][:take]
                   if "v_action_ids" in batch else None,
                   batch["a_action_ids"][:take]
                   if "a_action_ids" in batch else None,
                   {k: batch[k][:take]
                    for k in ("verb", "noun", "action", "class_id")
                    if k in batch})

    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """Top-1/top-5 accuracies of the window-vote ensemble over the
        validation split and the mean losses of its batches."""
        if self.state is None:
            self.init_state()
        acc = WindowVoteAccumulator(
            self.val_ds.windows.num_actions, _head_spec(self.cfg))
        avg = LossAverager()
        if self._val_banks is not None:
            self._run_bank_accum(acc, avg)
        else:
            for logits, losses, v_ids, a_ids, labels in \
                    self._eval_batches(self.val_ds):
                acc.update(logits, v_ids, a_ids, labels)
                avg.update({k: float(v) for k, v in losses.items()})
            acc.reduce_across_processes(self.mesh)
        stats = acc.summarize(self.dataset_name)
        stats.update(avg.averages())
        return self._log(stats, "val", epoch)

    def _best_tag(self, stats: Dict[str, float], epoch: int) -> str:
        tags = []
        if stats.get("action_top1", 0.0) > self.best["visual"]:
            self.best["visual"] = stats["action_top1"]
            self.last_best_epoch = epoch
            tags.append("visual")
        if stats.get("verb_noun_top1", 0.0) > self.best["visual_mt"]:
            self.best["visual_mt"] = stats["verb_noun_top1"]
            tags.append("mt")
        if stats.get("audio_top1", 0.0) > self.best["audio"]:
            self.best["audio"] = stats["audio_top1"]
            tags.append("audio")
        if stats.get("combined_top1", 0.0) > self.best["combined"]:
            self.best["combined"] = stats["combined_top1"]
            tags.append("combined")
        return "_".join(tags) if tags else "none"

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None,
            start_epoch: int = 0) -> Dict[str, float]:
        """Train and validate each epoch; checkpoints (``checkpoint.pt``
        and a ``best_<tag>.pt`` per improved top-1) when ``output_dir`` is
        set; stops early after ``early_stop_period`` epochs without a
        better action top-1."""
        epochs = epochs or self.tcfg.epochs
        if self.state is None:
            self.init_state()
        final: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            self.train_epoch(epoch)
            stats = self.validate(epoch)
            final = stats
            is_best = self._best_tag(stats, epoch)
            if self.output_dir:      # rank 0 writes
                ckpt.save_checkpoint(
                    self.output_dir, self.state, epoch=epoch + 1,
                    extra={"val_stats": {k: float(v)
                                         for k, v in stats.items()}},
                    is_best=is_best)
            if (self.tcfg.early_stop_period > 0 and
                    epoch - self.last_best_epoch >
                    self.tcfg.early_stop_period):
                self.logger.info("early stop at epoch %d", epoch + 1)
                break
        return final

    # ------------------------------------------------------------------
    def extract_predictions(self, dataset=None, path: Optional[str] = None):
        """The window-ensembled softmax predictions per GT action (the
        reference's recognition feature dump): ``action`` (with the
        ``v_narration_ids`` of its rows), ``verb``, ``noun``, ``audio``
        (with ``a_narration_ids``). Optionally pickled to ``path``."""
        if self.state is None:
            self.init_state()
        ds = dataset or self.val_ds
        acc = WindowVoteAccumulator(
            ds.windows.num_actions, _head_spec(self.cfg))
        if self._val_banks is not None and ds is self.val_ds:
            self._run_bank_accum(acc)
        else:
            for logits, _, v_ids, a_ids, labels in self._eval_batches(ds):
                acc.update(logits, v_ids, a_ids, labels)
            acc.reduce_across_processes(self.mesh)

        v_nid, a_nid = {}, {}
        for w in ds.windows.windows:
            for i, nid in zip(w.v_action_ids, w.v_narration_ids):
                v_nid[int(i)] = nid
            for i, nid in zip(w.a_action_ids, w.a_narration_ids):
                a_nid[int(i)] = nid
        expected = ds.windows.num_actions
        seen = int((acc.seen > 0).sum())
        if seen < expected:
            self.logger.warning("extraction missed %d / %d actions",
                                expected - seen, expected)

        out: Dict[str, object] = {}
        if "action" in acc.sums:
            out["action"], _ = acc.ensembled_scores("action")
            valid = np.flatnonzero(acc.v_labels[:, 2] != -1)
            out["v_narration_ids"] = [v_nid[int(i)] for i in valid]
        if "verb" in acc.sums:
            out["verb"], _ = acc.ensembled_scores("verb")
            out["noun"], _ = acc.ensembled_scores("noun")
        if "audio" in acc.sums:
            out["audio"], _ = acc.ensembled_scores("audio")
            valid = np.flatnonzero(acc.a_labels != -1)
            out["a_narration_ids"] = [a_nid[int(i)] for i in valid]
        if path and multihost.is_master():
            with open(path, "wb") as f:
                pickle.dump(out, f)
        return out
