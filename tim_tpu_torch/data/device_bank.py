"""Device-resident feature banks with an on-device window gather:
counterpart of ``tim_tpu/data/device_bank.py``.

Each split's per-video feature banks go to the card once (videos
concatenated along time into one [sum_T, A, D] tensor), with every
window's global feature rows, normalised times and labels (and GT
segments in detection) precomputed as device tensors
(``DeviceWindowTables`` for recognition, ``DetectionWindowTables``). A
batch is
then a tensor of window ids: the host only shuffles integers, and the
gather runs on the card. One augmentation set per feature token is drawn
on a CPU ``torch.Generator`` (a few KB of ids a step, moved to the card),
so the card and the CPU draw the same sets.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tim_tpu_torch.data.windows import WindowSet
from tim_tpu_torch.ops.dropout import draw


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` (a CPU tensor) on ``device``; to a CUDA device through pinned
    memory without blocking, so that the host does not wait for the
    card's queue (a pageable copy would)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DeviceFeatureBank:
    """All per-video [T, A, D] banks of a split, concatenated on
    ``device`` in ``dtype``."""

    def __init__(self, feats: Dict[str, np.ndarray],
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.offsets: Dict[str, int] = {}
        parts = []
        offset = 0
        for vid in sorted(feats):
            arr = np.asarray(feats[vid])
            self.offsets[vid] = offset
            offset += arr.shape[0]
            parts.append(arr)
        bank = np.concatenate(parts, axis=0)
        self.num_aug = bank.shape[1]
        self.dim = bank.shape[2]
        self.bank = torch.from_numpy(bank).to(device=device, dtype=dtype)

    def global_indices(self, video_id: str,
                       feat_indices: np.ndarray) -> np.ndarray:
        return np.asarray(feat_indices) + self.offsets[video_id]

    def gather(self, indices: torch.Tensor,
               aug_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices [B, F] global rows (and an augmentation set per token,
        else set 0) -> [B, F, D]."""
        rows = indices.long() * self.num_aug
        if aug_indices is not None:
            rows = rows + host_to_device(aug_indices, rows.device)
        flat = self.bank.view(-1, self.dim)
        return flat.index_select(0, rows.reshape(-1)).view(
            *indices.shape, self.dim)


def window_index_table(windows: WindowSet,
                       bank: DeviceFeatureBank) -> np.ndarray:
    """[num_windows, num_feats] global feature-row indices, precomputed
    once per split."""
    return np.stack([
        bank.global_indices(w.video_id, w.feat_indices)
        for w in windows.windows
    ]).astype(np.int32)


def _check_aligned_banks(v_bank: Optional[DeviceFeatureBank],
                         a_bank: Optional[DeviceFeatureBank]) -> None:
    """One global index table gathers BOTH banks, which is only correct
    when the two banks have identical per-video row layouts; a single
    extra row in one modality of one video would shift every later
    video's rows (in-bounds indices, silently wrong features)."""
    if v_bank is None or a_bank is None:
        return
    if (v_bank.offsets != a_bank.offsets
            or v_bank.bank.shape[0] != a_bank.bank.shape[0]):
        bad = sorted(k for k in (set(v_bank.offsets) | set(a_bank.offsets))
                     if v_bank.offsets.get(k) != a_bank.offsets.get(k))
        raise ValueError(
            "visual/audio feature banks are row-misaligned; the shared "
            "window index table requires identical per-video row counts "
            f"(totals {v_bank.bank.shape[0]} vs {a_bank.bank.shape[0]}; "
            f"first differing videos: {bad[:3]}). Re-extract the two "
            "modalities on a common feature-time grid.")


class DeviceWindowTables:
    """A recognition split resident on the banks' device: per-window
    feature-row indices, normalised times (feature times, then the query
    intervals, visual then audio, zero-padded) and -1-padded labels.
    Mirrors ``RecognitionDataset.__getitem__``. ``labels_host`` keeps the
    numpy labels for the runner's vote tables."""

    def __init__(self, windows: WindowSet,
                 v_bank: Optional[DeviceFeatureBank],
                 a_bank: Optional[DeviceFeatureBank],
                 v_feat_times: Optional[Dict[str, np.ndarray]] = None,
                 a_feat_times: Optional[Dict[str, np.ndarray]] = None):
        ws = windows
        nv, na = ws.max_visual_actions, ws.max_audio_actions
        n = len(ws.windows)
        _check_aligned_banks(v_bank, a_bank)
        ref_bank = v_bank or a_bank
        feat_idx = window_index_table(ws, ref_bank)
        nf = feat_idx.shape[1]
        n_mod = (v_bank is not None) + (a_bank is not None)
        times = np.zeros((n, n_mod * nf + nv + na, 2), np.float32)
        labels = {k: -np.ones((n, m), np.int64) for k, m in (
            ("verb", nv), ("noun", nv), ("action", nv), ("class_id", na))}

        # the reference's normalisation: (t - start) / window_size, >= 0
        for i, w in enumerate(ws.windows):
            row = 0
            for bank, ft in ((v_bank, v_feat_times), (a_bank, a_feat_times)):
                if bank is None:
                    continue
                if ft is None:
                    raise ValueError("DeviceWindowTables: feature times "
                                     "required per modality")
                times[i, row:row + nf] = ft[w.video_id][w.feat_indices, :2]
                row += nf
            times[i, row:row + len(w.v_queries)] = w.v_queries
            times[i, row + nv:row + nv + len(w.a_queries)] = w.a_queries
            times[i] = np.clip((times[i] - w.start_sec) / ws.window_size,
                               0.0, None)
            for col, key in enumerate(("verb", "noun", "action")):
                labels[key][i, :len(w.v_labels)] = w.v_labels[:, col]
            labels["class_id"][i, :len(w.a_labels)] = w.a_labels[:, 3]

        device = ref_bank.bank.device
        tables = {"feat_indices": feat_idx.astype(np.int64), "times": times,
                  **labels}
        self.tables = {k: torch.from_numpy(v).to(device)
                       for k, v in tables.items()}
        self.labels_host = labels
        self.num_windows = n

    def batch(self, window_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of [B] window ids (a tensor on the tables' device):
        ``feat_indices`` [B, F], ``times`` and the label rows."""
        return {k: v.index_select(0, window_ids)
                for k, v in self.tables.items()}


class DetectionWindowTables:
    """Detection split resident on the banks' device: feature-row
    indices, normalised feature times, window-normalised GT segments and
    labels, window start/size. Mirrors ``DetectionDataset.__getitem__``
    (round to 3 decimals then normalise, zero-padded segments, -1
    labels)."""

    def __init__(self, windows: WindowSet,
                 v_bank: Optional[DeviceFeatureBank],
                 a_bank: Optional[DeviceFeatureBank],
                 v_feat_times: Optional[Dict[str, np.ndarray]] = None,
                 a_feat_times: Optional[Dict[str, np.ndarray]] = None,
                 *, verb_only: bool = True,  # reference default
                 include_verb_noun: bool = False,
                 dataset_name: str = "epic"):
        ws = windows
        nv = max(ws.max_visual_actions, 1)
        na = max(ws.max_audio_actions, 1)
        n = len(ws.windows)
        _check_aligned_banks(v_bank, a_bank)
        ref_bank = v_bank or a_bank
        feat_idx = window_index_table(ws, ref_bank)
        nf = feat_idx.shape[1]
        n_mod = (v_bank is not None) + (a_bank is not None)

        times = np.zeros((n, n_mod * nf, 2), np.float32)
        v_seg = np.zeros((n, nv, 2), np.float32)
        a_seg = np.zeros((n, na, 2), np.float32)
        verb = -np.ones((n, nv), np.int64)
        noun = -np.ones((n, nv), np.int64)
        action = -np.ones((n, nv), np.int64)
        class_id = -np.ones((n, na), np.int64)
        win_start = np.zeros(n, np.float32)

        for i, w in enumerate(ws.windows):
            row = 0
            for bank, ft in ((v_bank, v_feat_times), (a_bank, a_feat_times)):
                if bank is None:
                    continue
                t = ft[w.video_id][w.feat_indices, :2]
                times[i, row:row + nf] = np.clip(
                    np.round(t - w.start_sec, 3) / ws.window_size, 0.0,
                    None)
                row += nf
            win_start[i] = w.start_sec
            if len(w.v_queries):
                seg = np.round(w.v_queries - w.start_sec, 3)
                v_seg[i, :len(seg)] = np.clip(seg / ws.window_size, 0.0,
                                              None)
                verb[i, :len(seg)] = w.v_labels[:, 0]
                noun[i, :len(seg)] = w.v_labels[:, 1]
                if dataset_name == "epic" and not include_verb_noun:
                    action[i, :len(seg)] = w.v_labels[:, 0] if verb_only \
                        else w.v_labels[:, 1]
                else:
                    action[i, :len(seg)] = w.v_labels[:, 2]
            if len(w.a_queries):
                seg = np.round(w.a_queries - w.start_sec, 3)
                a_seg[i, :len(seg)] = np.clip(seg / ws.window_size, 0.0,
                                              None)
                class_id[i, :len(seg)] = w.a_labels[:, 3]

        device = ref_bank.bank.device
        tables = {"feat_indices": feat_idx.astype(np.int64), "times": times,
                  "v_gt_segments": v_seg, "a_gt_segments": a_seg,
                  "window_start": win_start, "verb": verb, "noun": noun,
                  "action": action, "class_id": class_id}
        self.tables = {k: torch.from_numpy(v).to(device)
                       for k, v in tables.items()}
        self.window_size = float(ws.window_size)
        self.num_windows = n

    def batch(self, window_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of [B] window ids (a tensor on the tables' device):
        ``feat_indices`` [B, F] and the ``DetectionDataset`` keys."""
        out = {k: v.index_select(0, window_ids)
               for k, v in self.tables.items()}
        out["window_size"] = torch.full(
            window_ids.shape, self.window_size, dtype=torch.float32,
            device=window_ids.device)
        return out


def gather_window_batch(
    v_bank: Optional[DeviceFeatureBank],
    a_bank: Optional[DeviceFeatureBank],
    indices: torch.Tensor,                  # [B, F] global rows
    generator: Optional[torch.Generator] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(v_feats, a_feats) for a batch of windows, gathered on the banks'
    device, with one augmentation set per feature token drawn from
    ``generator`` (a CPU generator; visual first, then audio) like the host
    dataset; ``generator`` None takes the clean set 0. A
    ``ops.dropout.BatchRows`` generator draws the sets of the global batch
    and keeps this rank's rows."""
    out = []
    for bank in (v_bank, a_bank):
        if bank is None:
            out.append(None)
            continue
        aug = None
        if generator is not None and bank.num_aug > 1:
            aug = draw(generator, tuple(indices.shape),
                       lambda s, g, n=bank.num_aug: torch.randint(
                           0, n, s, generator=g))
        out.append(bank.gather(indices, aug))
    return out[0], out[1]
