"""Detection training and validation, one card a process: counterpart of
``tim_tpu/runner/detection.py``.

``DetectionRunner`` builds the model on its device (the CUDA card unless
``device="cpu"`` is asked for; without a card it raises), trains it with
``make_train_step`` and the TIM optimizer, validates with
``make_val_step`` (deterministic: kernel 1 on the card), keeps the best
model by validation loss, stops early and writes checkpoints
(``train.checkpoint``). Two data paths, as in JAX:

- host: ``batch_iterator`` over a ``DetectionDataset`` (numpy), each
  batch moved to the device;
- banked (``use_device_bank``): the whole split on the device
  (``DeviceFeatureBank``, ``DetectionWindowTables``), a batch a tensor of
  window ids; validation sums the losses on the device and reads them
  back once.

Several processes (``parallel.multihost.initialize``, one card each):
the runner's ``Mesh`` splits every global batch of ``batch_size``
windows into equal rank shares. The host path iterates each rank's
shard of the split (``batch_iterator(num_shards=, shard_index=)``, JAX's
wrap-around padding included); on the banked path every card holds the
whole bank, every rank draws the same window order and takes its slice of
each batch of ids. The steps sum the ranks' shares of the global loss
(``train.detection``); the dense dump gathers every rank's rows, then
keeps each window once, in window order. Rank 0 writes the checkpoints
and logs; every rank reads ``resume``.

The mAP chain: ``extract_dense_predictions`` dumps every window's dense
query scores and proposals (``make_inference_step``: kernel 1 on the
card), ``evaluate_mAP`` runs the dump through ``evals.format_predictions.
evaluate_detections`` (threshold, Soft-NMS, submission, mAP), and
``fit(eval_mAP_gt=...)`` reports it every ``eval_mAP_every`` epochs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tim_tpu_torch.config import DetectionConfig, MeshConfig, TrainConfig
from tim_tpu_torch.data.dataset import DetectionDataset, batch_iterator
from tim_tpu_torch.data.device_bank import (
    DetectionWindowTables, DeviceFeatureBank, host_to_device)
from tim_tpu_torch.evals.format_predictions import evaluate_detections
from tim_tpu_torch.evals.meters import LossAverager
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.models.tim import TimDetection, resolve_device
from tim_tpu_torch.parallel.mesh import make_mesh, shard_train_state
from tim_tpu_torch.train import checkpoint as ckpt
from tim_tpu_torch.train import detection as steps
from tim_tpu_torch.train.optim import make_optimizer
from tim_tpu_torch.train.state import TrainState, create_train_state
from tim_tpu_torch.utils.logging import log_json_stats, setup_logging

# the dump's column names of the inference step's score keys' heads
_HEAD_NAMES = {"v": "action", "verb": "verb", "noun": "noun", "a": "audio"}


def _tables(ds: DetectionDataset, device) -> tuple:
    """(v_bank, a_bank, DetectionWindowTables) of a split on ``device``."""
    v_bank = (DeviceFeatureBank(ds.visual.feats, device=device)
              if ds.visual is not None else None)
    a_bank = (DeviceFeatureBank(ds.audio.feats, device=device)
              if ds.audio is not None else None)
    tables = DetectionWindowTables(
        ds.windows, v_bank, a_bank,
        ds.visual.feat_times if ds.visual is not None else None,
        ds.audio.feat_times if ds.audio is not None else None,
        verb_only=ds.verb_only, include_verb_noun=ds.include_verb_noun,
        dataset_name=ds.dataset_name)
    return v_bank, a_bank, tables


class DetectionRunner:
    def __init__(
        self,
        cfg: DetectionConfig,
        tcfg: TrainConfig,
        train_ds: Optional[DetectionDataset],
        val_ds: Optional[DetectionDataset],
        *,
        mesh_cfg: MeshConfig = MeshConfig(),
        output_dir: Optional[str] = None,
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
        self.print_freq = print_freq
        self.logger = setup_logging(output_dir)
        self.exp_logger = experiment_logger
        self.device = resolve_device(device)
        self.mesh = mesh = make_mesh(mesh_cfg.data, mesh_cfg.model)
        self.model = TimDetection(
            cfg, device=self.device,
            generator=torch.Generator().manual_seed(tcfg.seed), mesh=mesh)
        self.steps_per_epoch = (max(len(train_ds) // tcfg.batch_size, 1)
                                if train_ds else 1)
        self._local_bs = mesh.local_batch(tcfg.batch_size)
        self._share = mesh.share(tcfg.batch_size)
        self._shard_args = mesh.shard_args
        self._train_step = steps.make_train_step(self.model, cfg, tcfg,
                                                 mesh=mesh)
        self._val_step = steps.make_val_step(self.model, cfg, tcfg, mesh)
        self.num_queries = generate_query_pyramid(
            cfg.inference_query_size).shape[0]
        self._infer_steps = {}     # top_k -> make_inference_step

        self._bank_step = self._val_banks = None
        if use_device_bank and train_ds is not None:
            v_bank, a_bank, self._tables = _tables(train_ds, self.device)
            self._bank_step = steps.make_bank_train_step(
                self.model, cfg, tcfg, v_bank, a_bank, mesh=mesh)
        if use_device_bank and val_ds is not None:
            self._val_banks = _tables(val_ds, self.device)

        self.state: Optional[TrainState] = None
        self.best_loss = float("inf")
        self.last_best_epoch = 0

    # ------------------------------------------------------------------
    def init_state(self, pretrained: Optional[str] = None) -> TrainState:
        """The optimizer over the model's parameters, after merging the
        shape-matched parameters of the checkpoint at ``pretrained`` (a
        ``.pt`` or the JAX package's msgpack or orbax checkpoint) into the
        model; the normaliser at ``TrainConfig.normaliser_init``."""
        if pretrained:
            ckpt.merge_params(self.model,
                              ckpt.load_checkpoint(pretrained)["params"])
        tcfg = self.tcfg
        optimizer = make_optimizer(
            self.model.parameters(), tcfg.lr, tcfg.weight_decay,
            total_steps=self.steps_per_epoch * tcfg.epochs,
            warmup_steps=self.steps_per_epoch * tcfg.warmup_epochs,
            min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm)
        self.state = shard_train_state(create_train_state(
            self.model, optimizer, normaliser=tcfg.normaliser_init),
            self.mesh)
        return self.state

    def resume(self, path: str) -> int:
        """Full training resume (parameters, optimizer, step, normaliser)
        from a ``.pt`` or the JAX package's msgpack or orbax checkpoint;
        returns the epoch to continue from. Every rank reads the
        checkpoint."""
        if self.state is None:
            self.init_state()
        payload = ckpt.load_checkpoint(path)
        shard_train_state(ckpt.restore_train_state(self.state, payload),
                          self.mesh)
        return int(payload.get("epoch", 0))

    def load_torch_checkpoint(self, state_dict: Mapping[str, torch.Tensor]
                              ) -> TrainState:
        """Load a reference detection checkpoint's state dict (the port
        uses its parameter names) strictly."""
        if self.state is None:
            self.init_state()
        self.model.load_state_dict(state_dict, strict=True)
        return shard_train_state(self.state, self.mesh)

    # ------------------------------------------------------------------
    def _to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: host_to_device(torch.from_numpy(np.asarray(v)),
                                  self.device)
                for k, v in batch.items() if not k.startswith("_")}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch, shuffled by a generator seeded ``seed + epoch``; the
        metrics of every ``print_freq``-th step are read back, logged and
        averaged."""
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
        for i, batch in enumerate(batches):
            metrics = step(self.state, batch)
            if i % self.print_freq == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                avg.update(metrics)
                self.logger.info("epoch %d iter %d | loss %.4f | "
                                 "normaliser %.1f%s", epoch + 1, i,
                                 metrics["loss"], metrics["normaliser"], tag)
        return self._log(avg, "train", epoch)

    # ------------------------------------------------------------------
    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """The detection losses on the validation windows (the reference
        keeps the model of least validation loss), last partial batch
        dropped. The banked path sums them on the device and reads the
        sums back once."""
        if self.state is None:
            self.init_state()
        self.val_ds.sample_augmentations = False
        bs = self.tcfg.batch_size
        avg = LossAverager()
        if self._val_banks is not None:
            v_bank, a_bank, tables = self._val_banks
            sums, n_batches = {}, tables.num_windows // bs
            ids = torch.arange(n_batches * bs, device=self.device)
            for chunk in ids.view(n_batches, bs)[:, self._share]:
                batch = steps.with_bank_features(tables.batch(chunk), v_bank,
                                                 a_bank)
                for k, val in self._val_step(self.state, batch).items():
                    sums[k] = sums.get(k, 0.0) + val.float()
            if n_batches:
                host = torch.stack(list(sums.values())).cpu().tolist()
                avg.update({k: s / n_batches for k, s in zip(sums, host)})
        else:
            for batch in batch_iterator(self.val_ds, self._local_bs,
                                        shuffle=False, **self._shard_args):
                metrics = self._val_step(self.state, self._to_device(batch))
                avg.update({k: float(v) for k, v in metrics.items()})
        return self._log(avg, "val", epoch)

    def _log(self, avg: LossAverager, split: str, epoch: int
             ) -> Dict[str, float]:
        stats = avg.averages()
        log_json_stats(self.logger, {"split": split, "epoch": epoch + 1,
                                     **stats})
        if self.exp_logger is not None:
            self.exp_logger.log({f"{split}/{k}": v for k, v in stats.items()})
        return stats

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None, start_epoch: int = 0,
            eval_mAP_gt=None, eval_mAP_every: int = 5,
            **map_kwargs) -> Dict[str, float]:
        """Train and validate each epoch; the best model by validation
        loss is checkpointed (``best_loss.pt``) beside the last
        (``checkpoint.pt``) when ``output_dir`` is set; stops early after
        ``early_stop_period`` epochs without a better loss.
        ``eval_mAP_gt`` (the evaluator's GT columns) adds the validation
        split's mAP (``evaluate_mAP(eval_mAP_gt, **map_kwargs)``) as
        ``val_avg_mAP`` every ``eval_mAP_every`` epochs."""
        epochs = epochs or self.tcfg.epochs
        if self.state is None:
            self.init_state()
        final: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            self.train_epoch(epoch)
            stats = self.validate(epoch)
            if (eval_mAP_gt is not None and eval_mAP_every > 0
                    and (epoch + 1) % eval_mAP_every == 0):
                _, avg, _ = self.evaluate_mAP(eval_mAP_gt, **map_kwargs)
                stats["val_avg_mAP"] = float(avg)
                log_json_stats(self.logger, {
                    "split": "val_mAP", "epoch": epoch + 1,
                    "avg_mAP": float(avg)})
            final = stats
            is_best = "none"
            if stats.get("loss", float("inf")) < self.best_loss:
                self.best_loss = stats["loss"]
                self.last_best_epoch = epoch
                is_best = "loss"
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
    def _infer_step(self, top_k: Optional[int]):
        if top_k not in self._infer_steps:
            self._infer_steps[top_k] = steps.make_inference_step(
                self.model, self.cfg, top_k)
        return self._infer_steps[top_k]

    def extract_dense_predictions(self, dataset=None, top_k=None
                                  ) -> Dict[str, np.ndarray]:
        """The dense proposal dump over every window of ``dataset`` (the
        validation split by default): column arrays for
        ``evals.format_predictions``, a row per (window, query), windows
        in ascending order: ``video_ids``, ``queries`` and
        ``v_proposals`` in video time, and per head its scores
        (``action``, ``verb``, ``noun``, ``audio``, ``a_proposals``).

        ``top_k``: only the k best classes per query, as
        ``<head>_topk_values`` / ``<head>_topk_classes`` (identical eval
        results whenever every class above the threshold fits in k;
        ``threshold_predictions_topk`` warns otherwise).

        On the banked path (the validation split, ``use_device_bank``) a
        batch is a range of window ids, the last one padded with its last
        window; on the host path ``batch_iterator`` pads with the batch's
        first window. Padded rows are dropped. Several processes: each
        rank infers its rows, every rank gathers all of them
        (``allgather_host_arrays``; the same row count on each), and each
        window is kept once, in window order."""
        if self.state is None:
            self.init_state()
        ds = dataset or self.val_ds
        ds.sample_augmentations = False
        infer = self._infer_step(top_k)
        bs = self.tcfg.batch_size
        win_idx, real, cols = [], [], {}

        def collect(out, idxs, ok):
            win_idx.append(np.asarray(idxs))
            real.append(ok)
            for key, val in out.items():
                if "_topk_" in key:
                    base, suffix = key.split("_topk_")
                    key = f"{_HEAD_NAMES[base]}_topk_{suffix}"
                elif key.endswith("_scores"):
                    key = _HEAD_NAMES[key[:-len("_scores")]]
                cols.setdefault(key, []).append(val.cpu().numpy())

        if self._val_banks is not None and dataset is None:
            v_bank, a_bank, tables = self._val_banks
            n = tables.num_windows
            for i in range(0, n, bs):
                ids = np.arange(i, min(i + bs, n))
                ok = np.arange(bs) < len(ids)
                ids = np.concatenate([ids, np.full(bs - len(ids), ids[-1])])
                ids, ok = ids[self._share], ok[self._share]
                batch = steps.with_bank_features(tables.batch(host_to_device(
                    torch.from_numpy(ids), self.device)), v_bank, a_bank)
                collect(infer(batch), ids, ok)
        else:
            lb = self._local_bs
            for batch in batch_iterator(ds, lb, shuffle=False,
                                        drop_last=False, with_indices=True,
                                        **self._shard_args):
                collect(infer(self._to_device(batch)), batch["_indices"],
                        np.arange(lb) < lb - batch["_pad"])

        # every rank's rows; then ascending window ids with their first
        # occurrence (JAX's order, independent of the sharding)
        real = self.mesh.allgather_host_arrays(np.concatenate(real))
        win_idx = self.mesh.allgather_host_arrays(
            np.concatenate(win_idx).astype(np.int64))[real]
        _, keep = np.unique(win_idx, return_index=True)
        win_idx = win_idx[keep]
        windows = ds.windows.windows
        video_ids = np.asarray([windows[int(j)].video_id for j in win_idx],
                               object)
        result = {"video_ids": np.repeat(video_ids, self.num_queries)}
        for key, chunks in cols.items():
            arr = self.mesh.allgather_host_arrays(
                np.concatenate(chunks))[real][keep]
            result[key] = arr.reshape(-1, arr.shape[-1])
        return result

    def evaluate_mAP(self, gt_columns, dataset=None, *, task="action",
                     score_key="action", proposals_key="v_proposals",
                     top_k=None, **eval_kwargs):
        """(mAP per tIoU, average mAP, submission) of the dense dump of
        ``dataset`` against ``gt_columns`` (``evals.format_predictions.
        gt_to_columns``); ``eval_kwargs`` go to ``evaluate_detections``.
        With ``top_k`` the top-k dump is evaluated, its class count taken
        from the head that ``score_key`` names."""
        dump = self.extract_dense_predictions(dataset, top_k=top_k)
        sc = (dump[score_key] if top_k is None else
              (dump[f"{score_key}_topk_values"],
               dump[f"{score_key}_topk_classes"]))
        if top_k is not None:
            vc = self.cfg.visual_classes
            head_sizes = {"audio": self.cfg.audio_classes, "verb": vc[0],
                          "noun": vc[1] if len(vc) == 3 else vc[-1]}
            eval_kwargs.setdefault(
                "topk_num_classes", head_sizes.get(score_key, vc[-1]))
        return evaluate_detections(
            dump["video_ids"], dump[proposals_key], sc,
            gt_columns, task=task, **eval_kwargs)
