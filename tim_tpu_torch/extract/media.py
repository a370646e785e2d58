"""Media prep: video -> frames / audio via ffmpeg subprocesses. A copy of
``tim_tpu/extract/media.py`` (a test pins it to the original).

Equivalents of the reference's ``feature_extractors/extract_frames.py``
(ffmpeg JPEG dump, multiprocessing fan-out) and
``auditory_slowfast/utils/extract_audio.py`` (wav extraction). These are
host-side prep tools; they no-op gracefully when ffmpeg is absent.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional, Tuple


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(
    video_path: str,
    out_dir: str,
    *,
    fps: Optional[float] = None,
    quality: int = 2,
    pattern: str = "frame_%010d.jpg",
) -> int:
    """Dump JPEG frames for one video; returns the frame count."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path, "-q:v", str(quality)]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [os.path.join(out_dir, pattern)]
    subprocess.run(cmd, check=True, capture_output=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(".jpg")])


def extract_audio(
    video_path: str,
    out_path: str,
    *,
    sampling_rate: int = 24000,
    mono: bool = True,
) -> str:
    """Extract a wav track (24 kHz mono by default, the ASF input rate)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path, "-vn",
           "-ar", str(sampling_rate)]
    if mono:
        cmd += ["-ac", "1"]
    cmd += [out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path


def probe_duration_fps(video_path: str) -> Tuple[float, float]:
    """(duration seconds, fps) via ffprobe — feeds
    ``extract.tables.build_video_info``."""
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=avg_frame_rate,duration",
         "-of", "csv=p=0", video_path],
        check=True, capture_output=True, text=True).stdout.strip()
    rate_str, duration_str = out.split(",")[:2]
    num, den = rate_str.split("/")
    return float(duration_str), float(num) / float(den)


def extract_frames_parallel(
    videos: Dict[str, str],
    frames_root: str,
    *,
    workers: int = 8,
    fps: Optional[float] = None,
) -> Dict[str, int]:
    """Fan out frame extraction over a thread pool
    (``extract_frames.py:43-44`` uses a Pool(40)). Threads, not
    processes: the work is ffmpeg subprocesses (the GIL is released
    waiting on them), and a process pool cannot pickle a local closure.
    """
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        vid, path = item
        return vid, extract_frames(
            path, os.path.join(frames_root, vid), fps=fps)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return dict(pool.map(one, videos.items()))
