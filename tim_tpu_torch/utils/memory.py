"""Host and device memory observability: counterpart of
``tim_tpu/utils/memory.py`` (the reference samples RAM and GPU memory in
every meter line, ``recognition/.../utils/misc.py:36-59``,
``meters.py:818-822``). The device figures come from the CUDA caching
allocator (``torch.cuda.memory_stats``) and the driver
(``torch.cuda.mem_get_info``), under the JAX package's keys."""

from __future__ import annotations

import resource
from typing import Dict, Optional

import torch


def host_memory_gb() -> float:
    """Peak RSS of this process in GiB."""
    rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss_kb / (1024.0 ** 2)


def device_memory_gb(device=None) -> Optional[Dict[str, float]]:
    """Memory of one CUDA device in GiB: ``in_use_gb`` (bytes the caching
    allocator has handed out now), ``peak_gb`` (their peak) and
    ``limit_gb`` (the device's total memory). ``device`` None means the
    current CUDA device; None is returned on the CPU (a CPU ``device``, or
    no card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    scale = 1024.0 ** 3
    return {"in_use_gb": stats.get("allocated_bytes.all.current", 0) / scale,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) / scale,
            "limit_gb": total / scale}


def memory_summary(device=None) -> str:
    """``ram <peak RSS>G`` and, on a CUDA device, ``hbm in use/peak/
    limit`` in GiB (the JAX package's format)."""
    parts = [f"ram {host_memory_gb():.2f}G"]
    dev = device_memory_gb(device)
    if dev:
        parts.append(
            "hbm " + "/".join(f"{v:.2f}G" for v in dev.values()))
    return " ".join(parts)
