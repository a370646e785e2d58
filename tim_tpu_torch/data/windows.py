"""Sliding-window construction over untrimmed videos: a copy of
``tim_tpu/data/windows.py`` (tests pin the two to equality).

Host-side numpy preprocessing that replicates the reference's window
semantics exactly (float rounding included):

- recognition: windows keep actions that *overlap* the window, clipped to
  it, if the clipped part is the full action or >= ``min_query_size``
  seconds;
- detection: every window of every video is kept; GT segments are only
  actions *fully inside* the window, and actions longer than the window are
  dropped globally.

The output is a flat list of fixed-schema ``Window`` records plus padding
maxima, ready for fixed-shape batching. The annotation builders
(``normalize_actions``, ``build_*_windows``) take the port's
``data.table.Table`` (``utils.pdpickle.read_pickle`` of the reference's
pickles) where the JAX package takes DataFrames, with the same
semantics: row order, the merged table's positional action ids, NaN and
the dtypes of the label columns alike.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from tim_tpu_torch.data.table import Table, isin


def timestamp_to_seconds(timestamp: str) -> float:
    hours, minutes, seconds = map(float, timestamp.split(":"))
    return hours * 3600.00 + minutes * 60.0 + seconds


def window_feat_indices(
    feat_times: np.ndarray,
    window_start: float,
    window_stop: float,
    feat_stride: int,
    num_feats: int,
) -> np.ndarray:
    """Pick ``num_feats`` feature rows covering the window
    (``sliding_window.py:426-440``): nearest feature start to the window
    start, nearest feature end to the window stop, strided, clipped, and
    right-padded by repeating the final index."""
    start_time = max(0.0, window_start)
    input_start = int(np.abs(feat_times[:, 0] - start_time).argmin())
    input_end = int(np.abs(feat_times[:, 1] - window_stop).argmin())

    idx = np.arange(input_start, input_end, feat_stride)
    if idx.size == 0:
        idx = np.asarray([input_start])
    idx = np.clip(idx, 0, len(feat_times) - 1)
    if idx.size < num_feats:
        idx = np.concatenate(
            [idx, np.full(num_feats - idx.size, idx[-1], idx.dtype)])
    return idx[:num_feats].astype(np.int64)


@dataclass
class Window:
    video_id: str
    start_sec: float
    stop_sec: float
    feat_indices: np.ndarray                 # [num_feats] int64
    # Per-modality queries/labels; empty arrays when absent.
    v_queries: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    v_labels: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.int64))
    v_action_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))
    v_narration_ids: List[str] = field(default_factory=list)
    a_queries: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    a_labels: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.int64))
    a_action_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))
    a_narration_ids: List[str] = field(default_factory=list)


@dataclass
class WindowSet:
    windows: List[Window]
    max_visual_actions: int
    max_audio_actions: int
    num_actions: int
    window_size: float
    min_query: float = 0.0
    max_query: float = 0.0

    def __len__(self):
        return len(self.windows)


LABEL_COLS = ("verb_class", "noun_class", "action_class", "class_id")


def save_window_set(path: str, ws: "WindowSet") -> None:
    """Cache a precomputed WindowSet (role of the reference's
    ``precomputed_windows/*.pth``, ``sliding_window.py:288-307``)."""
    import pickle

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(ws, f)


def load_window_set(path: str) -> Optional["WindowSet"]:
    import pickle

    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def normalize_actions(
    df, modality: str, dataset_name: str = "epic", detection: bool = False,
    window_size: Optional[float] = None,
):
    """Bring a raw annotation ``Table`` to the shared schema
    (``sliding_window.py:157-194``): seconds columns, -1 fill for absent
    label columns, modality-prefixed narration ids."""
    df = df.copy()
    if "start_sec" not in df:
        for col in ("start", "stop"):
            df[f"{col}_sec"] = np.asarray(
                [timestamp_to_seconds(t) for t in df[f"{col}_timestamp"]],
                np.float64)

    if modality == "visual":
        if dataset_name == "ave" and not detection:
            df["action_class"] = df["class_id"]
        else:
            df["class_id"] = -1
        if "verb_class" not in df:
            df["verb_class"] = -1
            df["noun_class"] = -1
        if "action_class" not in df:
            df["action_class"] = -1
    else:
        for col in ("verb_class", "noun_class", "action_class"):
            df[col] = -1

    keep = ["video_id", "start_sec", "stop_sec", *LABEL_COLS]
    df = df.select(keep)
    df.index_name = "narration_id"
    if detection:
        assert window_size is not None
        df = df.where((df["stop_sec"] - df["start_sec"]) < window_size)
    df = df.reset_index()
    prefix = "v_" if modality == "visual" else "a_"
    df["narration_id"] = [f"{prefix}{x}" for x in df["narration_id"]]
    return df


def _merge_actions(v_actions, a_actions, data_modality: str) -> Table:
    if data_modality == "visual":
        return v_actions
    if data_modality == "audio":
        return a_actions
    return Table.concat([v_actions, a_actions]).reset_index(drop=True)


def _clipped_group(grouped, vid, video_duration) -> Table:
    """A video's actions (``get_group``) with their stops clipped to the
    video's rounded-up duration (``.clip(upper=...)`` on the copy)."""
    vid_actions = grouped[vid].copy()
    vid_actions["stop_sec"] = np.minimum(vid_actions["stop_sec"],
                                         video_duration)
    return vid_actions


def build_recognition_windows(
    v_actions,
    a_actions,
    video_info,
    feat_times: Dict[str, np.ndarray],
    *,
    num_feats: int = 50,
    feat_stride: int = 3,
    feat_gap: float = 0.2,
    window_stride: float = 1.0,
    min_query_size: float = 0.2,
    data_modality: str = "audio_visual",
) -> WindowSet:
    """Precompute recognition windows. ``v_actions``/``a_actions`` are
    normalized Tables (see ``normalize_actions``) or None; ``video_info``
    is indexed by video id with a ``duration`` column; ``feat_times``
    maps video_id -> [T, >=2] (start, end) per feature row."""
    window_size = num_feats * feat_gap * feat_stride
    actions = _merge_actions(v_actions, a_actions, data_modality)
    num_actions = len(actions)

    video_info = video_info.where(isin(video_info.index,
                                       actions.unique("video_id")))
    all_n_ids = set(actions["narration_id"].tolist())
    grouped = actions.groups("video_id")

    windows: List[Window] = []
    seen: set = set()
    max_vis = max_aud = 0
    min_query, max_query = 2 * window_size, 0.0

    for vid, vinfo in video_info.rows():
        video_duration = math.ceil(vinfo["duration"])
        n_win = max(math.ceil(
            (math.ceil(video_duration) - window_size) / window_stride) + 1, 1)
        vid_actions = _clipped_group(grouped, vid, video_duration)

        starts = vid_actions["start_sec"]
        stops = vid_actions["stop_sec"]
        full_dur = np.round(stops - starts, 3)
        vt = feat_times[vid]

        for w in range(n_win):
            win_start = window_stride * w
            win_stop = min(video_duration, win_start + window_size)
            overlap = (starts < win_stop) & (stops > win_start)
            if not overlap.any():
                continue

            c_start = np.maximum(starts[overlap], win_start)
            c_stop = np.minimum(stops[overlap], win_stop)
            partial = np.round(c_stop - c_start, 3)
            keep = (partial == full_dur[overlap]) | (partial >= min_query_size)
            if not keep.any():
                continue

            sel = np.flatnonzero(overlap)[keep]
            q_times = np.stack(
                [c_start[keep], c_stop[keep]], axis=-1).astype(np.float32)
            q_labels = vid_actions.take(sel).select(LABEL_COLS).to_numpy(
                np.int64)
            n_ids = vid_actions["narration_id"][sel].tolist()
            a_ids = vid_actions.index[sel].astype(np.int64)

            is_vis = np.asarray(["v_" in n for n in n_ids])
            is_aud = np.asarray(["a_" in n for n in n_ids])

            min_query = min(min_query, float(partial[keep].min()))
            max_query = max(max_query, float(partial[keep].max()))
            # NOTE: the reference tracks the max over the *total* window
            # action count whenever either modality grows
            # (``sliding_window.py:262-266``) — replicated for parity.
            if int(is_vis.sum()) > max_vis:
                max_vis = len(sel)
            if int(is_aud.sum()) > max_aud:
                max_aud = len(sel)

            windows.append(Window(
                video_id=vid,
                start_sec=win_start,
                stop_sec=win_stop,
                feat_indices=window_feat_indices(
                    vt, win_start, win_stop, feat_stride, num_feats),
                v_queries=q_times[is_vis],
                v_labels=q_labels[is_vis],
                v_action_ids=a_ids[is_vis],
                v_narration_ids=[n for n, m in zip(n_ids, is_vis) if m],
                a_queries=q_times[is_aud],
                a_labels=q_labels[is_aud],
                a_action_ids=a_ids[is_aud],
                a_narration_ids=[n for n, m in zip(n_ids, is_aud) if m],
            ))
            seen.update(n_ids)

    missing = all_n_ids - seen
    assert not missing, (
        f"Windows only cover {len(seen)}/{num_actions} actions; "
        f"missing: {sorted(missing)[:10]}")

    return WindowSet(
        windows=windows, max_visual_actions=max_vis,
        max_audio_actions=max_aud, num_actions=num_actions,
        window_size=window_size, min_query=min_query, max_query=max_query)


def build_detection_windows(
    v_actions,
    a_actions,
    video_info,
    feat_times: Dict[str, np.ndarray],
    *,
    num_feats: int = 50,
    feat_stride: int = 3,
    feat_gap: float = 0.2,
    window_stride: float = 1.0,
    data_modality: str = "audio_visual",
    with_gt: bool = True,
) -> WindowSet:
    """Precompute detection windows: every window of every annotated video;
    GT segments only for actions fully inside (and shorter than) the window.
    ``with_gt=False`` reproduces the dense-extraction path
    (``detection/.../loader.py`` get_gt_segments=False)."""
    window_size = num_feats * feat_gap * feat_stride
    actions = _merge_actions(v_actions, a_actions, data_modality)
    num_actions = len(actions)
    video_info = video_info.where(isin(video_info.index,
                                       actions.unique("video_id")))
    grouped = actions.groups("video_id")

    windows: List[Window] = []
    max_vis = max_aud = 0
    min_query, max_query = 2 * window_size, 0.0

    for vid, vinfo in video_info.rows():
        video_duration = math.ceil(vinfo["duration"])
        n_win = max(math.ceil(
            (math.ceil(video_duration) - window_size) / window_stride) + 1, 1)
        vid_actions = _clipped_group(grouped, vid, video_duration)
        starts = vid_actions["start_sec"]
        stops = vid_actions["stop_sec"]
        vt = feat_times[vid]

        for w in range(n_win):
            win_start = window_stride * w
            win_stop = min(video_duration, win_start + window_size)
            win = Window(
                video_id=vid, start_sec=win_start, stop_sec=win_stop,
                feat_indices=window_feat_indices(
                    vt, win_start, win_stop, feat_stride, num_feats))

            if with_gt:
                inside = (starts >= win_start) & (stops <= win_stop)
                if inside.any():
                    sel = np.flatnonzero(inside)
                    dur = stops[inside] - starts[inside]
                    min_query = min(min_query, float(dur.min()))
                    max_query = max(max_query, float(dur.max()))
                    q_times = np.stack(
                        [starts[inside], stops[inside]], -1).astype(np.float32)
                    q_labels = vid_actions.take(sel).select(LABEL_COLS)\
                        .to_numpy(np.int64)
                    n_ids = vid_actions["narration_id"][sel].tolist()
                    is_vis = np.asarray(["v_" in n for n in n_ids])
                    is_aud = np.asarray(["a_" in n for n in n_ids])
                    if int(is_vis.sum()) > max_vis:
                        max_vis = len(sel)
                    if int(is_aud.sum()) > max_aud:
                        max_aud = len(sel)
                    win.v_queries = q_times[is_vis]
                    win.v_labels = q_labels[is_vis]
                    win.a_queries = q_times[is_aud]
                    win.a_labels = q_labels[is_aud]
            windows.append(win)

    return WindowSet(
        windows=windows, max_visual_actions=max_vis,
        max_audio_actions=max_aud, num_actions=num_actions,
        window_size=window_size,
        min_query=round(min_query, 3), max_query=round(max_query, 3))
