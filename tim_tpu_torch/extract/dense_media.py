"""Overlap-aware dense raw-media extraction (frame bank + pair-embed dedup):
counterpart of ``tim_tpu/extract/dense_media.py``.

Dense feature timesteps are 0.2 s apart while their clips span 1.1-2.1 s
(the reference's ``make_framepickle.py:37-38``: INTERVAL=1.1,
HOP_SIZE=0.2), so consecutive clips share ~80-90% of their frames. The
naive raw-media path uploads every clip in full and re-embeds every shared
frame pair in every clip that holds it. This module removes both
redundancies exactly (same pixels, same conv math):

1. **Frame bank**: each unique frame crosses host -> device once; clips
   are assembled on the card by gather.
2. **Pair-embed dedup**: both visual backbones start with a VALID Conv3D
   whose temporal kernel == stride == 2 (Swin patch (2, 4, 4), ViT tubelet
   2), so a frame pair's embedding does not depend on the rest of its
   clip. Each unique pair is embedded once (the backbones'
   ``embed_only``); clips gather their pair rows and enter the trunk
   through ``embedded=True``.

The plan (``ClipPlan``, ``build_clip_plan``, ``_pad_rows``,
``_chunk_rows``, ``_stream_plan``) is a numpy copy of the JAX module's.
``extract_dense_visual`` runs on the device of the model's parameters (a
module owns its weights: no ``variables`` argument); a plain call per
batch takes the place of the JAX module's jit cache, and
``dispatch="scan"`` (one ``lax.map`` program, TPU machinery) raises.

``mode="stream"`` does on CUDA what JAX leaves to async dispatch: each
batch's new rows are gathered on the host into a pinned buffer (a ring of
two, each refilled only after its last copy completed), copied to the card
on a side stream, and the compute stream waits on that copy's event; the
device copy is allocated on the side stream and marked used by the
compute stream (``record_stream``), so the caching allocator does not
hand its memory to the next copy while a gather still reads it. The
carried tail stays on the card, and the features are read back once, at
the end, so no read-back waits between two batches' uploads.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from tim_tpu_torch.extract.pipeline import OMNIVORE_MEAN, OMNIVORE_STD

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ClipPlan:
    """Dedup plan for a dense per-timestep clip table.

    unique_frames: [Nf] sorted original frame numbers (upload order).
    clip_idx:      [T, F] indices into ``unique_frames`` per clip.
    pairs:         [P, pt] unique temporal-kernel groups, as indices
                   into ``unique_frames``.
    pair_idx:      [T, F/pt] indices into ``pairs`` per clip.
    """

    unique_frames: np.ndarray
    clip_idx: np.ndarray
    pairs: np.ndarray
    pair_idx: np.ndarray

    @property
    def frame_dedup(self) -> float:
        """Pixels uploaded naive / frame-bank."""
        return self.clip_idx.size / max(len(self.unique_frames), 1)

    @property
    def pair_dedup(self) -> float:
        """Pair embeds computed naive / deduped."""
        return self.pair_idx.size / max(len(self.pairs), 1)


def build_clip_plan(clip_frames: np.ndarray, tubelet: int = 2) -> ClipPlan:
    """clip_frames: [T, F] integer frame numbers of every timestep's clip
    (any sampler — ``omnivore_frame_indices`` rows, uniform stride, ...).
    Pairs are formed exactly as the backbone's VALID temporal conv
    groups them: (f_0, f_1), (f_2, f_3), ... within each clip."""
    clip_frames = np.asarray(clip_frames)
    t, f = clip_frames.shape
    if f % tubelet:
        raise ValueError(f"clip length {f} not divisible by tubelet "
                         f"{tubelet}")
    uniq, inv = np.unique(clip_frames, return_inverse=True)
    clip_idx = inv.reshape(t, f).astype(np.int32)
    grouped = clip_idx.reshape(t * (f // tubelet), tubelet)
    pairs, pinv = np.unique(grouped, axis=0, return_inverse=True)
    pair_idx = pinv.reshape(t, f // tubelet).astype(np.int32)
    return ClipPlan(uniq, clip_idx, pairs.astype(np.int32), pair_idx)


def _pad_rows(x: np.ndarray, batch: int) -> np.ndarray:
    pad = (-len(x)) % batch
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    return x


def _chunk_rows(x: np.ndarray, batch: int) -> np.ndarray:
    """[N, ...] -> [ceil(N/batch), batch, ...] (last chunk padded by
    repeating the final row — same padding as ``_pad_rows``)."""
    x = _pad_rows(x, batch)
    return x.reshape(len(x) // batch, batch, *x.shape[1:])


@dataclasses.dataclass(frozen=True)
class _StreamStep:
    """One batch of the incremental stream plan (all fixed-shape).

    new_rows:  [cap_new] global frame rows to UPLOAD this step (only
               frames not already on device; padded by repetition).
    idx:       [B, F] gather positions into the step's device bank
               (= concat(tail, new)).
    tail_sel:  [cap_tail] positions in this bank of the rows the NEXT
               step reuses (carried device-to-device, never re-uploaded).
    """

    new_rows: np.ndarray
    idx: np.ndarray
    tail_sel: np.ndarray


def _stream_plan(clip_idx: np.ndarray, batch: int):
    """Incremental per-batch plan for ``mode="stream"``: each batch's
    bank is concat(previous tail carried ON DEVICE, newly uploaded
    rows), so transfers overlap compute and — for monotone
    sliding-window tables, the dense serving geometry — every unique
    frame crosses host->device exactly once. Dedup is only against the
    IMMEDIATELY PRECEDING batch: a frame gapped across non-adjacent
    batches (exotic samplers) re-uploads, and padded slots ship one
    duplicate row each; results stay exact either way. Shapes are
    padded to the max across batches. Returns (cap_tail, steps)."""
    idx = _pad_rows(clip_idx, batch)
    nb = len(idx) // batch
    uniq_per = [np.unique(idx[i * batch:(i + 1) * batch])
                for i in range(nb)]
    tails, news = [], []
    prev: set = set()
    for u in uniq_per:
        in_prev = np.asarray([r for r in u if r in prev], dtype=u.dtype)
        tails.append(in_prev)
        news.append(np.setdiff1d(u, in_prev))
        prev = set(u.tolist())
    cap_tail = max((len(t) for t in tails), default=0)
    cap_new = max(len(n) for n in news)

    steps = []
    for k in range(nb):
        pad_row = (tails[k][-1:] if len(tails[k]) else news[k][:1])
        new_rows = np.concatenate(
            [news[k], np.repeat(pad_row, cap_new - len(news[k]))])
        # positions of ACTUAL rows only — padded tail/new slots hold
        # duplicate (or, at step 0, zero-filled) content and must never
        # shadow a real row's position
        pos = {int(r): p for p, r in enumerate(tails[k])}
        for p, r in enumerate(news[k]):
            pos[int(r)] = cap_tail + p
        cur = idx[k * batch:(k + 1) * batch]
        step_idx = np.vectorize(pos.__getitem__)(cur).astype(np.int32)
        if k + 1 < nb:
            nxt = tails[k + 1]
            sel = np.asarray([pos[r] for r in nxt.tolist()], np.int32)
            sel = np.concatenate(
                [sel, np.zeros(cap_tail - len(sel), np.int32)])
        else:
            sel = np.zeros((cap_tail,), np.int32)
        steps.append(_StreamStep(new_rows, step_idx, sel))
    return cap_tail, steps


@functools.lru_cache(maxsize=8)
def uint8_normalizer(mean: Optional[tuple] = None,
                     std: Optional[tuple] = None,
                     dtype: str = "bfloat16") -> Callable:
    """``frame_transform`` for uint8 frame banks: /255, ImageNet
    normalize, cast, on the device of the clips (fp32 arithmetic, the
    host normalization's). Shipping the bank as uint8 quarters the
    host -> device bytes against fp32. Defaults to the clip
    preprocessing constants (``extract/pipeline.py`` OMNIVORE_MEAN/STD);
    cached, so repeated calls return the same function."""
    m_np = OMNIVORE_MEAN if mean is None else np.asarray(mean, np.float32)
    s_np = OMNIVORE_STD if std is None else np.asarray(std, np.float32)
    out_dtype = _DTYPES[dtype]
    consts: dict = {}

    def tf(clips: torch.Tensor) -> torch.Tensor:
        key = str(clips.device)
        if key not in consts:
            consts[key] = (torch.from_numpy(m_np).to(clips.device),
                           torch.from_numpy(s_np).to(clips.device))
        m, s = consts[key]
        x = clips.to(torch.float32) / 255.0
        return ((x - m) / s).to(out_dtype)
    return tf


def _ident(x):
    return x


class _Uploader:
    """Host rows -> a tensor on ``device``. On CUDA each call gathers the
    rows into one of two pinned buffers (waiting first for that buffer's
    previous copy), copies them on a side stream and makes the current
    stream wait for the copy; elsewhere a plain copy."""

    def __init__(self, host: np.ndarray, n_rows: int, device: torch.device):
        self.host, self.device = host, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            shape = (n_rows,) + host.shape[1:]
            self.buffers = [torch.from_numpy(np.empty(shape, host.dtype))
                            .pin_memory() for _ in range(2)]
            self.done = [None, None]
            self.stream = torch.cuda.Stream(device)
            self.turn = 0

    def __call__(self, rows: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(self.host[rows]).to(self.device)
        k = self.turn
        self.turn ^= 1
        if self.done[k] is not None:
            self.done[k].synchronize()
        buf = self.buffers[k]
        np.take(self.host, rows, axis=0, out=buf.numpy())
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            self.done[k] = torch.cuda.Event()
            self.done[k].record(self.stream)
        compute.wait_event(self.done[k])
        dev.record_stream(compute)
        return dev


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device`` (one copy from the host)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device)


def extract_dense_visual(
    model: torch.nn.Module,
    frames,                      # [Nf, H, W, 3] unique frames (host or dev)
    plan: ClipPlan,
    *,
    batch_size: int = 8,
    mode: str = "pair_embed",  # pair_embed | gather | stream | naive
    embed_batch: int = 64,
    pad_batches: bool = True,
    dispatch: str = "per_batch",
    frame_transform: Optional[Callable] = None,
    apply_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """[T, D] features for every timestep clip, computed overlap-aware on
    the device of ``model``'s parameters; a tensor on the host in the
    model's compute dtype (the dtype the JAX module returns).

    ``gather``: the frame bank on the card, clips assembled there, full
    backbone forward. ``pair_embed``: each unique frame pair embedded once,
    the trunk run from the gathered pair-embed bank. ``stream``: per-batch
    mini-banks uploaded as each batch is queued, the rows the next batch
    shares carried on the card (module docstring). ``naive``: clips
    assembled on the host and uploaded in full, the A/B baseline. All four
    give the same features (the same pixels and convolutions; in bf16 the
    pair-embed conv runs on a batch of pairs, not of clips, and may round
    differently).

    ``frame_transform`` (e.g. ``uint8_normalizer()``) runs on the card on
    the gathered or uploaded clips, before the backbone.
    ``dispatch="scan"`` is the JAX module's single-program TPU dispatch
    and raises here."""
    if dispatch == "scan":
        raise NotImplementedError(
            "dispatch='scan' is the JAX package's single-program TPU "
            "dispatch (lax.map over batch chunks); the port runs "
            "dispatch='per_batch'")
    if dispatch != "per_batch":
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if mode not in ("naive", "gather", "stream", "pair_embed"):
        raise ValueError(f"unknown mode {mode!r}")
    kw = apply_kwargs or {}
    tf = frame_transform if frame_transform is not None else _ident
    device = next(model.parameters()).device
    t = len(plan.clip_idx)
    feats = []

    def rows(idx):
        return _pad_rows(idx, batch_size) if pad_batches else idx

    if mode in ("naive", "stream"):
        host = (frames.cpu().numpy() if isinstance(frames, torch.Tensor)
                else np.asarray(frames))
    if mode == "naive":
        idx = rows(plan.clip_idx)
        for i in range(0, len(idx), batch_size):
            clips = _to_device(host[idx[i:i + batch_size]], device)
            feats.append(model(tf(clips), **kw))
    elif mode == "stream":
        cap_tail, steps = _stream_plan(plan.clip_idx, batch_size)
        upload = _Uploader(host, len(steps[0].new_rows), device)
        # the small index plans go up once, before the loop
        idx_all = _to_device(np.stack([s.idx for s in steps]).astype(
            np.int64), device)
        sel_all = _to_device(np.stack([s.tail_sel for s in steps]).astype(
            np.int64), device)
        tail = torch.zeros((cap_tail,) + host.shape[1:],
                           dtype=torch.from_numpy(host[:0]).dtype,
                           device=device)
        for k, s in enumerate(steps):
            bank = torch.cat([tail, upload(s.new_rows)])
            feats.append(model(tf(bank[idx_all[k]]), **kw))
            tail = bank[sel_all[k]]
    else:
        dev_frames = _to_device(frames, device)
        if mode == "gather":
            idx = _to_device(rows(plan.clip_idx).astype(np.int64), device)
            for i in range(0, len(idx), batch_size):
                feats.append(model(tf(dev_frames[idx[i:i + batch_size]]),
                                   **kw))
        else:
            # [b, pt, H, W, 3] -> [b, 1, h, w, C] -> [b, h, w, C] pair
            # embeds, then [b, F/pt, h, w, C] assembled clip embeddings
            prows = _to_device(_pad_rows(plan.pairs, embed_batch).astype(
                np.int64), device)
            embeds = [model(tf(dev_frames[prows[i:i + embed_batch]]),
                            embed_only=True, **kw)[:, 0]
                      for i in range(0, len(prows), embed_batch)]
            embed_bank = torch.cat(embeds)[:len(plan.pairs)]
            idx = _to_device(rows(plan.pair_idx).astype(np.int64), device)
            for i in range(0, len(idx), batch_size):
                feats.append(model(embed_bank[idx[i:i + batch_size]],
                                   embedded=True, **kw))
    return torch.cat(feats)[:t].cpu()
