"""Synthetic EPIC-style data for tests and benchmarks: a copy of
``tim_tpu/data/synthetic.py``.

Fabricates videos with per-timestep features and overlapping action
annotations in the exact schema the reference consumes (annotation
tables with ``start_timestamp``/``stop_timestamp``, feature-time
tables, per-video ``[T, A, D]`` banks). The tables are the port's
``data.table.Table``s, with the columns, index and values of the JAX
copy's DataFrames.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tim_tpu_torch.data.table import Table


def _fmt_ts(sec: float) -> str:
    h = int(sec // 3600)
    m = int((sec % 3600) // 60)
    s = sec % 60
    return f"{h:02d}:{m:02d}:{s:09.6f}"


def make_video_info(durations: Dict[str, float]) -> Table:
    return Table({
        "duration": list(durations.values()),
        "fps": [50.0] * len(durations),
    }, index=list(durations.keys()), index_name="video_id")


def make_feat_times(
    durations: Dict[str, float], feat_gap: float = 0.2,
    feat_len: float = 1.1,
) -> Dict[str, np.ndarray]:
    """Fixed-interval feature table like ``make_framepickle.py`` (INTERVAL
    1.1s, HOP 0.2s)."""
    out = {}
    for vid, dur in durations.items():
        starts = np.arange(0.0, max(dur - feat_len, feat_gap), feat_gap,
                           dtype=np.float32)
        out[vid] = np.stack([starts, starts + feat_len], axis=-1)
    return out


def make_actions(
    durations: Dict[str, float],
    rng: np.random.Generator,
    *,
    per_video: int = 12,
    classes: Tuple[int, ...] = (97, 300, 3806),
    audio: bool = False,
    min_len: float = 0.4,
    max_len: float = 8.0,
) -> Table:
    rows = []
    for vid, dur in durations.items():
        for _ in range(per_video):
            length = float(rng.uniform(min_len, min(max_len, dur * 0.5)))
            start = float(rng.uniform(0.0, max(dur - length, 0.1)))
            row = {
                "video_id": vid,
                "start_timestamp": _fmt_ts(start),
                "stop_timestamp": _fmt_ts(min(start + length, dur)),
            }
            if audio:
                row["class_id"] = int(rng.integers(0, classes[0]))
                row["description"] = "sound"
            else:
                if len(classes) == 3:
                    row["verb_class"] = int(rng.integers(0, classes[0]))
                    row["noun_class"] = int(rng.integers(0, classes[1]))
                    row["action_class"] = int(rng.integers(0, classes[2]))
                else:
                    row["action_class"] = int(rng.integers(0, classes[0]))
                row["narration"] = "do thing"
            rows.append(row)
    prefix = "a" if audio else "v"
    return Table.from_records(
        rows, index=[f"{prefix}{i:05d}" for i in range(len(rows))],
        index_name="narration_id")


def make_features(
    feat_times: Dict[str, np.ndarray],
    dim: int,
    rng: np.random.Generator,
    num_aug: int = 2,
) -> Dict[str, np.ndarray]:
    return {
        vid: rng.normal(size=(len(t), num_aug, dim)).astype(np.float32)
        for vid, t in feat_times.items()
    }


def synthetic_epic(
    seed: int = 0,
    num_videos: int = 3,
    video_seconds: float = 90.0,
    visual_dim: int = 64,
    audio_dim: int = 48,
    visual_classes: Tuple[int, ...] = (9, 11, 13),
    audio_classes: int = 7,
    per_video: int = 10,
):
    """Full synthetic dataset bundle: (durations, video_info, v/a actions,
    v/a feat_times, v/a features)."""
    rng = np.random.default_rng(seed)
    durations = {
        f"P{i:02d}_{i:02d}": video_seconds + 7.0 * i
        for i in range(num_videos)
    }
    video_info = make_video_info(durations)
    feat_times = make_feat_times(durations)
    v_actions = make_actions(durations, rng, per_video=per_video,
                             classes=visual_classes)
    a_actions = make_actions(durations, rng, per_video=per_video,
                             classes=(audio_classes,), audio=True)
    v_feats = make_features(feat_times, visual_dim, rng)
    a_feats = make_features(feat_times, audio_dim, rng)
    return dict(
        durations=durations, video_info=video_info,
        v_actions=v_actions, a_actions=a_actions,
        v_feat_times=feat_times, a_feat_times=feat_times,
        v_feats=v_feats, a_feats=a_feats,
    )
