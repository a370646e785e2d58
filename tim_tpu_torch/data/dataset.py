"""Fixed-shape example assembly and batching: a copy of
``tim_tpu/data/dataset.py`` (tests pin the two to equality).

A plain numpy pipeline: every example has a static shape (queries/labels
padded to the split maxima); per-host sharding replaces
``DistributedSampler``. The train and validation steps move a batch to the
device (``runner.detection``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from tim_tpu_torch.data.windows import Window, WindowSet


def pad_rows(x, n, fill, dtype):
    """Pad the leading axis to ``n`` rows with ``fill`` (requires
    ``len(x) <= n``)."""
    padded = np.full((n, *x.shape[1:]), fill, dtype)
    padded[:len(x)] = x
    return padded


class FeatureStore:
    """Per-video feature bank: video_id -> [T, A, D] (A = augmentation sets)
    plus feature-time table video_id -> [T, >=2].

    Mirrors the reference's all-in-RAM cache
    (``sliding_window.py:111-139``); .npy files use the same on-disk layout
    as the reference extractors so existing feature dumps load directly.
    """

    def __init__(self, feats: Dict[str, np.ndarray],
                 feat_times: Dict[str, np.ndarray]):
        self.feats = feats
        self.feat_times = feat_times
        first = next(iter(feats.values()))
        self.num_aug = first.shape[1]
        self.dim = first.shape[2]

    @classmethod
    def from_npy_dir(cls, data_path: str, split: str, feat_time_table,
                     video_ids=None) -> "FeatureStore":
        """Load ``<data_path>/<split>/<video_id>.npy`` files for every video
        in the feature-time ``Table`` (``utils.pdpickle.read_pickle`` of
        the reference's pickle; ``sliding_window.py:19-32``): a video's
        rows in table order, sorted by ``start_sec``, the remaining columns
        but ``video_id`` and ``narration_sec`` as float32 in the table's
        column order."""
        feats, times = {}, {}
        if video_ids is None:
            video_ids = feat_time_table.unique("video_id").tolist()
        by_video = feat_time_table.groups("video_id")
        for vid in video_ids:
            rows = by_video.get(vid, feat_time_table.take([]))
            rows = rows.sort_by("start_sec")
            drop = [c for c in ("video_id", "narration_sec") if c in rows]
            times[vid] = rows.drop(drop).to_numpy(np.float32)
            feats[vid] = np.load(
                os.path.join(data_path, split, f"{vid}.npy"), mmap_mode="r")
        return cls(feats, times)


class RecognitionDataset:
    """Window -> fixed-shape example (``sliding_window.py:341-421``)."""

    def __init__(
        self,
        windows: WindowSet,
        visual_store: Optional[FeatureStore],
        audio_store: Optional[FeatureStore],
        rng: Optional[np.random.Generator] = None,
        sample_augmentations: bool = True,
    ):
        self.windows = windows
        self.visual = visual_store
        self.audio = audio_store
        self.rng = rng or np.random.default_rng(0)
        self.sample_augmentations = sample_augmentations

    def __len__(self):
        return len(self.windows.windows)

    @property
    def num_time_rows(self):
        n = 0
        if self.visual is not None:
            n += len(self.windows.windows[0].feat_indices)
        if self.audio is not None:
            n += len(self.windows.windows[0].feat_indices)
        return (n + self.windows.max_visual_actions
                + self.windows.max_audio_actions)

    def _aug_indices(self, store: FeatureStore, n: int) -> np.ndarray:
        if self.sample_augmentations and store.num_aug > 1:
            return self.rng.integers(0, store.num_aug, size=n)
        return np.zeros(n, np.int64)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        win: Window = self.windows.windows[index]
        ws = self.windows
        idx = win.feat_indices
        nf = len(idx)

        times = []
        out: Dict[str, np.ndarray] = {}
        if self.visual is not None:
            aug = self._aug_indices(self.visual, nf)
            out["v_feats"] = np.ascontiguousarray(
                self.visual.feats[win.video_id][idx, aug]).astype(np.float32)
            times.append(self.visual.feat_times[win.video_id][idx, :2])
        if self.audio is not None:
            aug = self._aug_indices(self.audio, nf)
            out["a_feats"] = np.ascontiguousarray(
                self.audio.feats[win.video_id][idx, aug]).astype(np.float32)
            times.append(self.audio.feat_times[win.video_id][idx, :2])

        nv, na = ws.max_visual_actions, ws.max_audio_actions


        v_q = pad_rows(win.v_queries, nv, 0.0, np.float32)
        a_q = pad_rows(win.a_queries, na, 0.0, np.float32)
        v_l = pad_rows(win.v_labels, nv, -1, np.int64)
        a_l = pad_rows(win.a_labels, na, -1, np.int64)

        times = np.concatenate(times + [v_q, a_q], axis=0)
        times = np.clip(
            (times - win.start_sec) / ws.window_size, 0.0, None)

        out.update({
            "times": times.astype(np.float32),
            "verb": v_l[:, 0],
            "noun": v_l[:, 1],
            "action": v_l[:, 2],
            "class_id": a_l[:, 3],
            "v_action_ids": pad_rows(win.v_action_ids, nv, -1, np.int64),
            "a_action_ids": pad_rows(win.a_action_ids, na, -1, np.int64),
        })
        return out


class DetectionDataset:
    """Window -> fixed-shape detection example
    (``detection/.../sliding_window.py:324-399``)."""

    def __init__(
        self,
        windows: WindowSet,
        visual_store: Optional[FeatureStore],
        audio_store: Optional[FeatureStore],
        rng: Optional[np.random.Generator] = None,
        sample_augmentations: bool = True,
        verb_only: bool = True,   # reference default, sliding_window.py:55
        include_verb_noun: bool = False,
        dataset_name: str = "epic",
    ):
        self.windows = windows
        self.visual = visual_store
        self.audio = audio_store
        self.rng = rng or np.random.default_rng(0)
        self.sample_augmentations = sample_augmentations
        self.verb_only = verb_only
        self.include_verb_noun = include_verb_noun
        self.dataset_name = dataset_name

    def __len__(self):
        return len(self.windows.windows)

    def _aug_indices(self, store, n):
        if self.sample_augmentations and store.num_aug > 1:
            return self.rng.integers(0, store.num_aug, size=n)
        return np.zeros(n, np.int64)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        win: Window = self.windows.windows[index]
        ws = self.windows
        idx = win.feat_indices
        nf = len(idx)

        times = []
        out: Dict[str, np.ndarray] = {}
        if self.visual is not None:
            aug = self._aug_indices(self.visual, nf)
            out["v_feats"] = np.ascontiguousarray(
                self.visual.feats[win.video_id][idx, aug]).astype(np.float32)
            times.append(self.visual.feat_times[win.video_id][idx, :2])
        if self.audio is not None:
            aug = self._aug_indices(self.audio, nf)
            out["a_feats"] = np.ascontiguousarray(
                self.audio.feats[win.video_id][idx, aug]).astype(np.float32)
            times.append(self.audio.feat_times[win.video_id][idx, :2])

        times = np.concatenate(times, axis=0)
        times = np.clip(
            np.round(times - win.start_sec, 3) / ws.window_size, 0.0, None)
        out["times"] = times.astype(np.float32)

        nv, na = max(ws.max_visual_actions, 1), max(ws.max_audio_actions, 1)


        v_seg = np.round(win.v_queries - win.start_sec, 3)
        a_seg = np.round(win.a_queries - win.start_sec, 3)
        v_seg = pad_rows(v_seg, nv, 0.0, np.float32)
        a_seg = pad_rows(a_seg, na, 0.0, np.float32)
        v_l = pad_rows(win.v_labels, nv, -1, np.int64)
        a_l = pad_rows(win.a_labels, na, -1, np.int64)

        if self.dataset_name == "epic" and not self.include_verb_noun:
            action = v_l[:, 0] if self.verb_only else v_l[:, 1]
        else:
            action = v_l[:, 2]

        out.update({
            "v_gt_segments": np.clip(v_seg / ws.window_size, 0.0, None),
            "a_gt_segments": np.clip(a_seg / ws.window_size, 0.0, None),
            "verb": v_l[:, 0],
            "noun": v_l[:, 1],
            "action": action,
            "class_id": a_l[:, 3],
            "window_start": np.float32(win.start_sec),
            "window_size": np.float32(ws.window_size),
        })
        return out


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    with_indices: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked fixed-shape batches; per-host sharding replaces
    ``DistributedSampler`` (``datasets/loader.py:50``). With
    ``drop_last=True`` the final partial batch is dropped (reference
    behavior via drop_last in training)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng(0)).shuffle(order)
    if num_shards > 1:
        # DistributedSampler semantics: wrap-around pad so every shard has
        # the same length — all processes take the same number of steps
        # (unequal counts would deadlock the mesh collectives).
        total = -(-n // num_shards) * num_shards
        if total > n:
            order = np.concatenate([order, order[:total - n]])
        order = order[shard_index::num_shards]

    for i in range(0, len(order), batch_size):
        chunk = order[i:i + batch_size]
        pad = 0
        if len(chunk) < batch_size:
            if drop_last:
                return
            # pad by repeating the first window; "_pad" tells consumers how
            # many trailing rows are duplicates (metric accumulators must
            # skip them or they double-count)
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.full(pad, chunk[0])])
        examples = [dataset[int(j)] for j in chunk]
        batch = {k: np.stack([e[k] for e in examples])
                 for k in examples[0]}
        batch["_pad"] = pad
        if with_indices:
            # dataset indices of each row — consumers that need the source
            # window (dense extraction) can't rely on iteration order once
            # the split is sharded across hosts
            batch["_indices"] = chunk.copy()
        yield batch
