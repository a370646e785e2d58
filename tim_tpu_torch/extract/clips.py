"""EK100 clip dataset for VideoMAE finetuning: counterpart of
``tim_tpu/extract/clips.py`` (the reference's
``feature_extractors/VideoMAE/ek100.py``, EKRawFrameClsDataset).

Frame-dir JPEG clips of EPIC action segments with the VideoMAE finetune
recipe: segment-based frame sampling, per-clip RandAugment
(rand-m7-n4-mstd0.5-inc1), ImageNet normalization, random-resized-crop +
horizontal flip, RandomErasing after normalization (per frame), and
``num_sample`` independently-augmented clips per training example.
Validation = short-side resize + center crop; test mode expands every
sample into ``test_num_segment x test_num_crop`` temporally-strided /
spatially-slid views. Clips come back channels-last float32 [T, S, S, 3].

The index samplers and the ImageNet constants are copies. The resizes
take no ``cv2``: the JAX package calls ``cv2.resize(..., INTER_LINEAR)``
on float32 frames, which is bilinear with half-pixel centres and an edge
clamp, its source coordinates in float64 and its two passes (along the
width, then the height) in float32; ``resize_bilinear`` does the same on
host tensors. (``F.interpolate(mode="bilinear")`` computes the source
coordinates in float32 and differs from cv2 by up to 5e-5 of the largest
value at 256 x 456 -> 224 x 224, where this function is within 1e-6.)
Every random draw (``random_resized_crop``'s tries and fallback, the flip,
the erasing seed) is taken from the generator in JAX's order, so the same
generator gives the same clips. ``jpeg_frame_reader`` reads JPEGs with
the port's own decoder (``utils.jpeg.read_jpegs``), pixels bit-equal to
the JAX package's ``cv2.imread`` + ``cvtColor(BGR2RGB)``, the Exif
orientation applied as ``imread`` applies it; neither cv2 nor PIL is
imported.

``annotations`` is anything that gives arrays by column name: the port's
``data.table.Table`` (``read_csv`` of the reference's CSVs), a ``dict``
of numpy arrays, or a pandas DataFrame (as in JAX).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tim_tpu_torch.extract.augment import random_erasing

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# frame index sampling (``ek100.py:267-334`` load_frame index math)
# ---------------------------------------------------------------------------

def sample_train_indices(total_frames: int, num_segment: int,
                         rng: np.random.Generator) -> np.ndarray:
    avg = total_frames // num_segment
    if avg > 0:
        return (np.arange(num_segment) * avg
                + rng.integers(0, avg, size=num_segment)).astype(int)
    if total_frames > num_segment:
        return np.sort(rng.integers(0, total_frames, size=num_segment))
    return np.asarray([0] * (num_segment - total_frames)
                      + list(range(total_frames)), int)


def sample_val_indices(total_frames: int, num_segment: int) -> np.ndarray:
    avg = total_frames // num_segment
    if avg > 0:
        return (np.arange(num_segment) * avg + avg // 2).astype(int)
    if total_frames > num_segment:
        return np.arange(num_segment)
    return np.asarray([0] * (num_segment - total_frames)
                      + list(range(total_frames)), int)


def sample_test_indices(total_frames: int, num_segment: int,
                        test_num_segment: int) -> np.ndarray:
    """All test views' indices, sorted (``ek100.py:270-281``); the view for
    chunk ``ck`` is ``all[ck::test_num_segment]`` after the temporal
    stride slice in ``__getitem__``."""
    tick = total_frames / float(num_segment)
    idx = []
    for t_seg in range(test_num_segment):
        idx.extend(int(t_seg * tick / test_num_segment + tick * x)
                   for x in range(num_segment))
    return np.sort(np.asarray(idx, int))


# ---------------------------------------------------------------------------
# pixel ops (cv2's INTER_LINEAR on float32 frames, without cv2)
# ---------------------------------------------------------------------------

def _linear_taps(n_in: int, n_out: int):
    """cv2's linear taps along one axis: source indices (i0, i1) and the
    weight of i1, from half-pixel centres ``(d + 0.5) * n_in / n_out -
    0.5`` in float64, clamped at both edges (weight 0 there)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(x).astype(np.int64)
    frac = x - i0
    frac[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    edge = i0 >= n_in - 1
    frac[edge] = 0.0
    i0[edge] = n_in - 1
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = torch.from_numpy(frac.astype(np.float32))
    return torch.from_numpy(i0), torch.from_numpy(i1), w1


def resize_bilinear(frames: np.ndarray, height: int,
                    width: int) -> np.ndarray:
    """float32 frames [T, H, W, C] -> [T, height, width, C], as
    ``cv2.resize(f, (width, height), interpolation=cv2.INTER_LINEAR)``
    resizes each frame: the width pass, then the height pass, in
    float32."""
    x = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    c0, c1, wx = _linear_taps(x.shape[2], width)
    x = (x.index_select(2, c0) * (1.0 - wx)[:, None]
         + x.index_select(2, c1) * wx[:, None])
    r0, r1, wy = _linear_taps(x.shape[1], height)
    x = (x.index_select(1, r0) * (1.0 - wy)[:, None, None]
         + x.index_select(1, r1) * wy[:, None, None])
    return x.numpy()


def resize_short_side(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w = frames.shape[:3]
    if h <= w:
        nh, nw = size, max(int(round(w * size / h)), size)
    else:
        nh, nw = max(int(round(h * size / w)), size), size
    return resize_bilinear(frames, nh, nw)


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    h, w = frames.shape[1:3]
    top = (h - size) // 2
    left = (w - size) // 2
    return frames[:, top:top + size, left:left + size]


def random_resized_crop(frames: np.ndarray, size: int,
                        rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (0.75, 4 / 3)
                        ) -> np.ndarray:
    """torchvision RandomResizedCrop semantics, one crop per clip
    (``spatial_sampling`` with scale [0.08, 1], aspect [3/4, 4/3])."""
    h, w = frames.shape[1:3]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * aspect)))
        ch = int(round(np.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = frames[:, top:top + ch, left:left + cw]
            return resize_bilinear(crop, size, size)
    # torchvision fallback: clamp to the nearest valid aspect ratio,
    # then center crop (not necessarily square before the resize)
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, min(h, int(round(w / ratio[0])))
    elif in_ratio > ratio[1]:
        cw, ch = min(w, int(round(h * ratio[1]))), h
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return resize_bilinear(frames[:, top:top + ch, left:left + cw], size,
                           size)


def normalize(frames: np.ndarray) -> np.ndarray:
    return ((frames.astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD)


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

def jpeg_frame_reader(data_path: str,
                      filename_tmpl: str = "img_{:05d}.jpg") -> Callable:
    """Reader for the reference's frame-dir layout: 1-based JPEG names
    offset by the segment's start frame (``ek100.py:282-286,320-326``).
    A clip's frames are decoded in one call into uint8 [T, H, W, 3] RGB,
    oriented as ``cv2.imread`` orients them; a missing frame raises
    ``FileNotFoundError``."""
    from tim_tpu_torch.utils.jpeg import read_jpegs

    def read(video_id: str, indices: np.ndarray,
             frame_offset: int) -> np.ndarray:
        return read_jpegs(
            [os.path.join(data_path, video_id,
                          filename_tmpl.format(int(idx) + 1 + frame_offset))
             for idx in indices], apply_orientation=True)

    return read


def _column(annotations, name: str) -> np.ndarray:
    return np.asarray(annotations[name])


class EK100ClipDataset:
    """Annotation rows -> augmented clips + (verb, noun) labels.

    ``annotations``: video_id / start_frame / stop_frame / verb_class /
    noun_class columns (the reference's csv schema), as a ``Table``, a
    ``dict`` of arrays or a DataFrame. ``frame_reader(video_id, indices,
    frame_offset) -> uint8 [T, H, W, 3]`` — injectable so that clips come from any source.
    ``rand_augment`` None: the finetune recipe's ``VideoRandAugment``
    (Pillow's ops of the port's own, ``extract.imageops``).
    """

    def __init__(
        self,
        annotations,
        frame_reader: Callable,
        *,
        mode: str = "train",
        num_frames: int = 16,
        crop_size: int = 224,
        short_side_size: int = 256,
        num_sample: int = 2,
        test_num_segment: int = 10,
        test_num_crop: int = 3,
        rand_augment: Optional[Callable] = None,
        reprob: float = 0.25,
        rng: Optional[np.random.Generator] = None,
    ):
        if mode not in ("train", "validation", "test"):
            raise ValueError(f"mode {mode!r}: train, validation or test")
        self.mode = mode
        self.num_frames = num_frames
        self.crop_size = crop_size
        self.short_side_size = short_side_size
        self.num_sample = num_sample if mode == "train" else 1
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        self.reprob = reprob
        self.rng = rng or np.random.default_rng(0)
        self.read = frame_reader
        # finetune recipe: rand-m7-n4-mstd0.5-inc1 (run_class_finetuning
        # ``--aa`` default), the exact timm engine
        if rand_augment is None:
            from tim_tpu_torch.extract.autoaug import VideoRandAugment
            rand_augment = VideoRandAugment(
                "rand-m7-n4-mstd0.5-inc1", crop_size=crop_size,
                interpolation="bicubic")
        self.rand_augment = rand_augment

        start = _column(annotations, "start_frame").astype(int)
        self.video_ids = _column(annotations, "video_id").tolist()
        self.frame_offsets = start.tolist()
        self.total_frames = (_column(annotations, "stop_frame").astype(int)
                             - start).tolist()
        self.verbs = _column(annotations, "verb_class").astype(int).tolist()
        self.nouns = _column(annotations, "noun_class").astype(int).tolist()

        if mode == "test":
            self.test_views = [
                (i, ck, cp)
                for ck in range(test_num_segment)
                for cp in range(test_num_crop)
                for i in range(len(self.video_ids))
            ]

    def __len__(self):
        if self.mode == "test":
            return len(self.test_views)
        return len(self.video_ids)

    # ------------------------------------------------------------------
    def _aug_clip(self, frames: np.ndarray) -> np.ndarray:
        """One independently-augmented training view
        (``ek100.py:212-267`` _aug_frame)."""
        frames = self.rand_augment(frames)
        clip = normalize(frames)
        clip = random_resized_crop(clip, self.crop_size, self.rng)
        if self.rng.random() < 0.5:
            clip = clip[:, :, ::-1]          # horizontal flip
        if self.reprob > 0:
            import random as _random
            r = _random.Random(int(self.rng.integers(2 ** 31)))
            # the reference erases AFTER normalization with N(0,1) fill,
            # each frame independently (timm RandomErasing on the
            # [T, C, H, W] clip)
            clip = random_erasing(clip, probability=self.reprob,
                                  normalized=True, per_frame=True, rng=r)
        return np.ascontiguousarray(clip, np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.mode == "train":
            idx = sample_train_indices(self.total_frames[index],
                                       self.num_frames, self.rng)
            frames = self.read(self.video_ids[index], idx,
                               self.frame_offsets[index])
            clips = np.stack([self._aug_clip(frames)
                              for _ in range(self.num_sample)])
            return {"video": clips,                    # [S, T, s, s, 3]
                    "verb": np.full(self.num_sample, self.verbs[index]),
                    "noun": np.full(self.num_sample, self.nouns[index])}

        if self.mode == "validation":
            idx = sample_val_indices(self.total_frames[index],
                                     self.num_frames)
            frames = self.read(self.video_ids[index], idx,
                               self.frame_offsets[index])
            clip = center_crop(
                resize_short_side(normalize(frames), self.short_side_size),
                self.crop_size)
            return {"video": np.ascontiguousarray(clip, np.float32),
                    "verb": np.int64(self.verbs[index]),
                    "noun": np.int64(self.nouns[index])}

        i, ck, cp = self.test_views[index]
        idx = sample_test_indices(self.total_frames[i], self.num_frames,
                                  self.test_num_segment)
        frames = self.read(self.video_ids[i], idx, self.frame_offsets[i])
        buf = resize_short_side(normalize(frames), self.short_side_size)
        # temporal stride view + spatial slide (``ek100.py:188-205``)
        t, h, w = buf.shape[:3]
        step = (max(h, w) - self.short_side_size) / (self.test_num_crop - 1)
        start = int(cp * step)
        if h >= w:
            view = buf[ck::self.test_num_segment,
                       start:start + self.short_side_size]
        else:
            view = buf[ck::self.test_num_segment, :,
                       start:start + self.short_side_size]
        return {"video": np.ascontiguousarray(view, np.float32),
                "verb": np.int64(self.verbs[i]),
                "noun": np.int64(self.nouns[i]),
                "view": np.asarray([ck, cp]),
                "sample_index": np.int64(i)}
