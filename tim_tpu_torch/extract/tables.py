"""Feature-time and video-info tables: a copy of
``tim_tpu/extract/tables.py`` that returns the port's ``data.table.Table``
where the original returns a DataFrame, with the same columns, index and
values (a test pins the two).

Equivalents of the reference's data-prep scripts
(``feature_extractors/make_framepickle.py`` — fixed 1.1 s intervals every
0.2 s — and ``make_videoinfo.py``), producing the pickles the sliding-
window dataset consumes, without the cv2/ffmpeg dependency (durations and
fps are passed in).
"""

from __future__ import annotations

from typing import Dict

from tim_tpu_torch.data.table import Table


def build_feature_time_table(
    durations: Dict[str, float],
    *,
    interval: float = 1.1,
    hop: float = 0.2,
    fps: Dict[str, float] | float = 50.0,
) -> Table:
    """Table with narration_id index and columns (video_id, start_sec,
    stop_sec, narration_sec, start_frame, stop_frame), one row per fixed
    feature interval (``make_framepickle.py:37-86``)."""
    rows, ids = [], []
    for vid, duration in durations.items():
        vid_fps = fps[vid] if isinstance(fps, dict) else fps
        start = 0.0
        index = 1
        while (start + interval) < duration:
            rows.append({
                "video_id": vid,
                "start_sec": round(start, 2),
                "stop_sec": round(start + interval, 2),
                "narration_sec": round(start + interval / 2, 2),
                "start_frame": int(round(start * vid_fps)),
                "stop_frame": int(round((start + interval) * vid_fps)),
            })
            ids.append(f"{vid}_{index}")
            start += hop
            index += 1
    return Table.from_records(rows, index=ids, index_name="narration_id")


def build_video_info(
    durations: Dict[str, float], fps: Dict[str, float] | float = 50.0
) -> Table:
    """video_id-indexed (duration, fps) table (``make_videoinfo.py``)."""
    return Table({
        "duration": list(durations.values()),
        "fps": [fps[v] if isinstance(fps, dict) else fps
                for v in durations],
    }, index=list(durations.keys()), index_name="video_id")
