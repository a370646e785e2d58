"""1-D NMS / Soft-NMS for the serving call: a copy of
``tim_tpu/evals/nms.py``'s host path (``batched_nms`` and what it reaches).

The native kernel is the port's own copy of the C++ source,
``csrc/host/nms1d.cc``, compiled with ``g++`` on first use into
``tim_tpu_torch/build/`` and loaded with ctypes. Where it cannot be built
(no ``g++``), the numpy versions below, with the same semantics, run
instead. Tests pin the results to the JAX package's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host", "nms1d.cc")
_LIB_DIR = os.path.join(_PKG, "build")
_LIB = os.path.join(_LIB_DIR, "libnms1d.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or (
                    os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
                os.makedirs(_LIB_DIR, exist_ok=True)
                # unique temp name + atomic rename: other processes never
                # load a half-written library
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.nms_1d.restype = ctypes.c_int64
        lib.nms_1d.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float,
                               i64p]
        lib.softnms_1d.restype = ctypes.c_int64
        lib.softnms_1d.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, f32p, i64p]
        lib.softnms_1d_multiclass.restype = ctypes.c_int64
        lib.softnms_1d_multiclass.argtypes = [
            f32p, f32p, i64p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, f32p, i64p, i64p]
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def nms_1d(segs: np.ndarray, scores: np.ndarray,
           iou_threshold: float) -> np.ndarray:
    """Greedy NMS; returns kept original indices, score-descending."""
    segs = np.ascontiguousarray(segs, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(segs)
    if n == 0:
        return np.zeros(0, np.int64)
    lib = _load_native()
    if lib is not None:
        keep = np.empty(n, np.int64)
        k = lib.nms_1d(_fptr(segs), _fptr(scores), n,
                       ctypes.c_float(iou_threshold), _iptr(keep))
        return keep[:k].copy()
    return _nms_1d_numpy(segs, scores, iou_threshold)


def softnms_1d(
    segs: np.ndarray, scores: np.ndarray, iou_threshold: float,
    sigma: float = 0.5, min_score: float = 0.001, method: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Soft-NMS; returns (segments [k,2], decayed scores [k], original
    indices [k]) in processed (score) order."""
    segs = np.ascontiguousarray(segs, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(segs)
    if n == 0:
        return (np.zeros((0, 2), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    lib = _load_native()
    if lib is not None:
        dets = np.empty((n, 3), np.float32)
        inds = np.empty(n, np.int64)
        k = lib.softnms_1d(_fptr(segs), _fptr(scores), n,
                           ctypes.c_float(iou_threshold),
                           ctypes.c_float(sigma), ctypes.c_float(min_score),
                           method, _fptr(dets), _iptr(inds))
        return dets[:k, :2].copy(), dets[:k, 2].copy(), inds[:k].copy()
    return _softnms_1d_numpy(segs, scores, iou_threshold, sigma, min_score,
                             method)


def softnms_1d_multiclass(
    segs: np.ndarray, scores: np.ndarray, cls_idxs: np.ndarray,
    iou_threshold: float, sigma: float = 0.5, min_score: float = 0.001,
    method: int = 2,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """All-classes Soft-NMS in one native call: per-class ``softnms_1d``
    over ascending class ids, results concatenated (unsorted across
    classes). Returns (segments [k,2], decayed scores [k], class ids [k]),
    or None without the native library (the caller then loops over the
    classes)."""
    n = len(segs)
    if n == 0:
        return (np.zeros((0, 2), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    lib = _load_native()
    if lib is None:
        return None
    segs = np.ascontiguousarray(segs, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    cls64 = np.ascontiguousarray(cls_idxs, np.int64)
    dets = np.empty((n, 3), np.float32)
    cls_out = np.empty(n, np.int64)
    inds = np.empty(n, np.int64)
    k = lib.softnms_1d_multiclass(
        _fptr(segs), _fptr(scores), _iptr(cls64), n,
        ctypes.c_float(iou_threshold), ctypes.c_float(sigma),
        ctypes.c_float(min_score), method,
        _fptr(dets), _iptr(cls_out), _iptr(inds))
    return dets[:k, :2].copy(), dets[:k, 2].copy(), cls_out[:k].copy()


# ---------------------------------------------------------------------------
# numpy versions (the same semantics as the native kernel)
# ---------------------------------------------------------------------------

def _iou_row(seg, segs, lens, seg_len):
    lo = np.maximum(seg[0], segs[:, 0])
    hi = np.minimum(seg[1], segs[:, 1])
    inter = np.clip(hi - lo, 0.0, None)
    return inter / (seg_len + lens - inter)


def _nms_1d_numpy(segs, scores, iou_threshold):
    lens = segs[:, 1] - segs[:, 0] + 1e-6
    order = np.argsort(-scores, kind="stable")
    alive = np.ones(len(segs), bool)
    keep = []
    for pos, i in enumerate(order):
        if not alive[pos]:
            continue
        keep.append(i)
        rest = order[pos + 1:]
        ious = _iou_row(segs[i], segs[rest], lens[rest], lens[i])
        alive[pos + 1:] &= ~(ious >= iou_threshold)
    return np.asarray(keep, np.int64)


def _softnms_1d_numpy(segs, scores, iou_threshold, sigma, min_score,
                      method):
    start = segs[:, 0].copy()
    end = segs[:, 1].copy()
    sc = scores.copy()
    lens = end - start + 1e-6
    idx = np.arange(len(segs), dtype=np.int64)
    count = len(segs)
    out_segs, out_scores, out_inds = [], [], []

    i = 0
    while i < count:
        best = i + int(np.argmax(sc[i:count]))
        for arr in (start, end, sc, lens, idx):
            arr[i], arr[best] = arr[best], arr[i]
        out_segs.append((start[i], end[i]))
        out_scores.append(sc[i])
        out_inds.append(idx[i])

        j = i + 1
        while j < count:
            lo = max(start[i], start[j])
            hi = min(end[i], end[j])
            inter = max(0.0, hi - lo)
            ovr = inter / (lens[i] + lens[j] - inter)
            weight = 1.0
            if method == 0:
                weight = 0.0 if ovr >= iou_threshold else 1.0
            elif method == 1:
                weight = 1.0 - ovr if ovr >= iou_threshold else 1.0
            elif method == 2:
                weight = np.exp(-(ovr * ovr) / sigma)
            sc[j] *= weight
            if sc[j] < min_score:
                last = count - 1
                for arr in (start, end, sc, lens, idx):
                    arr[j] = arr[last]
                count -= 1
                j -= 1
            j += 1
        i += 1

    return (np.asarray(out_segs, np.float32).reshape(-1, 2),
            np.asarray(out_scores, np.float32),
            np.asarray(out_inds, np.int64))


# ---------------------------------------------------------------------------
# segment voting + the multi-class entry point
# ---------------------------------------------------------------------------

def seg_voting(nms_segs, all_segs, all_scores, iou_threshold,
               score_offset: float = 1.5):
    """Refine kept segments by IoU-weighted voting over all candidates.
    A kept segment with zero total voting weight keeps its un-voted
    segment (the reference divides by zero there)."""
    lo = np.maximum(nms_segs[:, None, 0], all_segs[None, :, 0])
    hi = np.minimum(nms_segs[:, None, 1], all_segs[None, :, 1])
    inter = np.clip(hi - lo, 0.0, None)
    lens_n = (nms_segs[:, 1] - nms_segs[:, 0])[:, None]
    lens_a = (all_segs[:, 1] - all_segs[:, 0])[None, :]
    iou = inter / (lens_n + lens_a - inter)
    w = (iou >= iou_threshold) * all_scores[None, :] * iou
    wsum = w.sum(axis=1, keepdims=True)
    voted = np.divide(w, np.where(wsum > 0, wsum, 1.0)) @ all_segs
    return np.where(wsum > 0, voted, nms_segs)


def batched_nms(
    segs: np.ndarray,
    scores: np.ndarray,
    cls_idxs: np.ndarray,
    iou_threshold: float,
    min_score: float,
    sigma: float = 0.5,
    method: int = 2,
    nms_kind: str = "soft",
    multi_class: bool = True,
    voting_thresh: float = 0.75,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (Soft-)NMS, then a global score sort."""
    if len(segs) == 0:
        return (np.zeros((0, 2), np.float32), np.zeros(0, np.float32),
                np.zeros(0, cls_idxs.dtype))

    segs = np.asarray(segs, np.float32)
    scores = np.asarray(scores, np.float32)

    def run_one(s, sc, ci):
        if nms_kind == "soft":
            out_s, out_sc, inds = softnms_1d(
                s, sc, iou_threshold, sigma, min_score, method)
            return out_s, out_sc, ci[inds]
        valid = sc > min_score if min_score > 0 else slice(None)
        s2, sc2, ci2 = s[valid], sc[valid], ci[valid]
        keep = nms_1d(s2, sc2, iou_threshold)
        return s2[keep], sc2[keep], ci2[keep]

    if multi_class:
        fused = (softnms_1d_multiclass(
            segs, scores, cls_idxs, iou_threshold, sigma, min_score, method)
            if nms_kind == "soft" else None)
        if fused is not None:
            new_segs, new_scores, new_cls = fused
            new_cls = new_cls.astype(cls_idxs.dtype, copy=False)
        else:
            parts = []
            for cls in np.unique(cls_idxs):
                sel = cls_idxs == cls
                parts.append(run_one(segs[sel], scores[sel], cls_idxs[sel]))
            new_segs = np.concatenate([p[0] for p in parts])
            new_scores = np.concatenate([p[1] for p in parts])
            new_cls = np.concatenate([p[2] for p in parts])
    else:
        new_segs, new_scores, new_cls = run_one(segs, scores, cls_idxs)
        if voting_thresh > 0 and len(new_segs):
            new_segs = seg_voting(new_segs, segs, scores, voting_thresh)

    order = np.argsort(-new_scores, kind="stable")
    return new_segs[order], new_scores[order], new_cls[order]


def nms_1d_torch(segs, scores, iou_threshold: float, max_keep: int):
    """On-device greedy NMS with a static output size: counterpart of the
    JAX package's ``nms_1d_jax``. ``segs`` [N, 2] and ``scores`` [N] are
    tensors on any device; returns (keep indices [max_keep], -1 where
    invalid; valid mask [max_keep]) on that device, with no read-back.
    O(N * max_keep) masked ops, for proposals that already live on the
    card."""
    import torch

    n = segs.shape[0]
    lens = segs[:, 1] - segs[:, 0] + 1e-6
    alive = torch.ones(n, dtype=torch.bool, device=segs.device)
    rows = torch.arange(n, device=segs.device)
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    keep, valid = [], []
    for _ in range(max_keep):
        masked = torch.where(alive, scores, neg_inf)
        i = torch.argmax(masked)
        ok = masked[i] > neg_inf
        lo = torch.maximum(segs[i, 0], segs[:, 0])
        hi = torch.minimum(segs[i, 1], segs[:, 1])
        inter = torch.clamp_min(hi - lo, 0.0)
        iou = inter / (lens[i] + lens - inter)
        # the selected index is removed explicitly: a zero-length top
        # segment can have self-IoU below the threshold and would
        # otherwise be selected again every step
        alive = alive & ~(iou >= iou_threshold) & ok & (rows != i)
        keep.append(torch.where(ok, i, torch.full_like(i, -1)))
        valid.append(ok)
    if not keep:
        return (torch.zeros(0, dtype=torch.long, device=segs.device),
                torch.zeros(0, dtype=torch.bool, device=segs.device))
    return torch.stack(keep), torch.stack(valid)
