"""Host-side training augmentations for feature extraction. The
counterpart of ``tim_tpu/extract/augment.py`` (numpy; its RandAugment ops
run through ``extract.imageops``, Pillow's arithmetic without PIL, where
the original calls PIL; a test pins it to the original).

- SpecAugment for audio spectrograms
  (``auditory_slowfast/slowfast/datasets/spec_augment.py``): time warp,
  frequency masks, time masks (masks fill with the spectrogram mean). The
  time warp here is a piecewise-linear temporal resample with the same
  (point, distance) sampling as the reference's sparse_image_warp variant —
  distributionally equivalent, far cheaper on CPU.
- RandAugment for video frames (Pillow's ops), the timm policy subset the
  reference uses ("rand-m15-mstd0.5-inc1" for Omnivore,
  "rand-m7-n4-mstd0.5-inc1" for VideoMAE): increasing-magnitude
  transforms, std-0.5 magnitude noise.

These run on the host data path (augmentations are byte-image bound),
never on the device, matching where the reference runs them.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tim_tpu_torch.extract import imageops as ops

# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------


def time_warp(spec: np.ndarray, warp: int = 5,
              rng: Optional[random.Random] = None) -> np.ndarray:
    """Warp the time axis around a random anchor by up to ``warp`` steps
    (piecewise-linear resample)."""
    rng = rng or random
    t = spec.shape[0]
    if t <= 2 * warp:
        return spec
    anchor = rng.randrange(warp, t - warp)
    dist = rng.randrange(-warp, warp)
    if dist == 0:
        return spec
    target = anchor + dist
    src_pos = np.concatenate([
        np.linspace(0, anchor, target, endpoint=False),
        np.linspace(anchor, t - 1, t - target),
    ])
    idx0 = np.clip(np.floor(src_pos).astype(int), 0, t - 1)
    idx1 = np.clip(idx0 + 1, 0, t - 1)
    frac = (src_pos - idx0)[:, None]
    return ((1 - frac) * spec[idx0] + frac * spec[idx1]).astype(spec.dtype)


def freq_mask(spec: np.ndarray, max_width: int = 27, num_masks: int = 1,
              replace_with_zero: bool = False,
              rng: Optional[random.Random] = None) -> np.ndarray:
    """Mask random frequency bands ([T, F] layout;
    ``spec_augment.py:26-44``)."""
    rng = rng or random
    out = spec.copy()
    n_freq = out.shape[1]
    for _ in range(num_masks):
        f = rng.randrange(0, max_width)
        f0 = rng.randrange(0, n_freq - f)
        if f == 0:
            return out
        end = rng.randrange(f0, f0 + f)
        out[:, f0:end] = 0.0 if replace_with_zero else out.mean()
    return out


def time_mask(spec: np.ndarray, max_width: int = 25, num_masks: int = 1,
              replace_with_zero: bool = False,
              rng: Optional[random.Random] = None) -> np.ndarray:
    rng = rng or random
    out = spec.copy()
    t = out.shape[0]
    for _ in range(num_masks):
        w = rng.randrange(0, max_width)
        t0 = rng.randrange(0, t - w)
        if w == 0:
            return out
        end = rng.randrange(t0, t0 + w)
        out[t0:end] = 0.0 if replace_with_zero else out.mean()
    return out


def spec_augment(spec: np.ndarray,
                 rng: Optional[random.Random] = None,
                 exact_warp: bool = True) -> np.ndarray:
    """The reference's combined transform (warp + 2 freq masks + 2 time
    masks, ``spec_augment.py`` combined_transforms). ``exact_warp`` uses
    the faithful sparse-image-warp port (``extract/spec_warp.py``,
    reference quirks included); False keeps the earlier piecewise-linear
    resample approximation."""
    if exact_warp:
        from tim_tpu_torch.extract.spec_warp import time_warp_exact
        seed = (rng or random).randrange(2 ** 31)
        # spec is [T, F] here; the reference warps [F, T]
        spec = time_warp_exact(
            spec.T, rng=np.random.default_rng(seed)).T
    else:
        spec = time_warp(spec, rng=rng)
    spec = freq_mask(spec, num_masks=2, rng=rng)
    spec = time_mask(spec, num_masks=2, rng=rng)
    return spec


def random_erasing(
    frames: np.ndarray,
    *,
    probability: float = 0.25,
    area_range: Tuple[float, float] = (0.02, 1 / 3),
    aspect_range: Tuple[float, float] = (0.3, 3.3),
    per_frame: bool = False,
    normalized: bool = False,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Cutout-style random erasing with per-pixel gaussian fill (timm
    'pixel' mode, used by the VideoMAE finetuning recipe,
    ``VideoMAE/random_erasing.py``). ``per_frame=True`` matches timm's
    batched call on a [T, C, H, W] clip: every frame rolls probability,
    region, and fill independently (the reference erases AFTER ImageNet
    normalization, ``ek100.py:253-264``, so pass ``normalized=True``
    there). ``per_frame=False`` keeps one roll + one region for the
    whole clip."""
    rng = rng or random
    out = frames.copy()
    t, h, w, c = out.shape
    log_aspect = (np.log(aspect_range[0]), np.log(aspect_range[1]))
    np_rng = None

    def erase_one(view):
        nonlocal np_rng
        for _ in range(10):
            area = rng.uniform(*area_range) * h * w
            aspect = np.exp(rng.uniform(*log_aspect))
            eh = int(round(np.sqrt(area * aspect)))
            ew = int(round(np.sqrt(area / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                # randint is INCLUSIVE of img_h - h in the reference
                # (random_erasing.py:106-107) — randrange would make the
                # bottom/right-most placement unreachable
                top = rng.randint(0, h - eh)
                left = rng.randint(0, w - ew)
                if np_rng is None:
                    np_rng = np.random.default_rng(rng.randrange(2 ** 31))
                noise = np_rng.normal(size=(eh, ew, c))
                view[..., top:top + eh, left:left + ew, :] = (
                    noise if normalized else noise * 50 + 128)
                return

    if per_frame:
        for f in range(t):
            if rng.random() < probability:
                erase_one(out[f])
    else:
        if rng.random() < probability:
            erase_one(out)
    if normalized:
        return out.astype(frames.dtype)
    return np.clip(out, 0, 255).astype(frames.dtype)


# ---------------------------------------------------------------------------
# RandAugment (timm-style, Pillow's ops)
# ---------------------------------------------------------------------------

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)


def _enhance_factor_inc(level):
    # "inc1": magnitude increases the effect symmetrically around 1.0
    return 1.0 + (level / _MAX_LEVEL) * 0.9 * random.choice([-1, 1])


def _apply_op(img: np.ndarray, name: str, level: float) -> np.ndarray:
    """One op on one uint8 frame [H, W, 3] (``imageops``: Pillow's
    arithmetic; ``rotate`` and ``transform`` at Pillow's default NEAREST)."""
    if name == "AutoContrast":
        return ops.autocontrast(img)
    if name == "Equalize":
        return ops.equalize(img)
    if name == "Invert":
        return ops.invert(img)
    if name == "Rotate":
        deg = (level / _MAX_LEVEL) * 30.0 * random.choice([-1, 1])
        return ops.rotate(img, deg, ops.NEAREST, _FILL)
    if name == "Posterize":
        bits = 4 - int((level / _MAX_LEVEL) * 4)
        return ops.posterize(img, max(bits, 1))
    if name == "Solarize":
        thresh = 256 - int((level / _MAX_LEVEL) * 256)
        return ops.solarize(img, thresh)
    if name == "SolarizeAdd":
        # np.where(i < 128, clip(i + add, 0, 255), i) in the original: the
        # same bytes as timm's table for every integer add
        return ops.solarize_add(img, int((level / _MAX_LEVEL) * 110))
    if name == "Color":
        return ops.color(img, _enhance_factor_inc(level))
    if name == "Contrast":
        return ops.contrast(img, _enhance_factor_inc(level))
    if name == "Brightness":
        return ops.brightness(img, _enhance_factor_inc(level))
    if name == "Sharpness":
        return ops.sharpness(img, _enhance_factor_inc(level))
    h, w = img.shape[:2]
    if name in ("ShearX", "ShearY"):
        shear = (level / _MAX_LEVEL) * 0.3 * random.choice([-1, 1])
        mat = (1, shear, 0, 0, 1, 0) if name == "ShearX" else \
            (1, 0, 0, shear, 1, 0)
        return ops.affine(img, mat, ops.NEAREST, _FILL)
    if name in ("TranslateX", "TranslateY"):
        frac = (level / _MAX_LEVEL) * 0.45 * random.choice([-1, 1])
        dx = frac * w if name == "TranslateX" else 0
        dy = frac * h if name == "TranslateY" else 0
        return ops.affine(img, (1, 0, dx, 0, 1, dy), ops.NEAREST, _FILL)
    raise ValueError(f"unknown op {name}")


RAND_AUGMENT_OPS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
)


class RandAugment:
    """``rand-m{M}-n{N}-mstd0.5-inc1``: N random ops at magnitude
    ~N(M, 0.5*10) clipped to [0, 10]. The same op sequence applies to every
    frame of a clip (call ``sample_ops`` once per clip)."""

    def __init__(self, magnitude: int = 15, num_ops: int = 2,
                 mstd: float = 0.5,
                 ops: Sequence[str] = RAND_AUGMENT_OPS):
        self.magnitude = magnitude
        self.num_ops = num_ops
        self.mstd = mstd
        self.ops = list(ops)

    def sample_ops(self) -> List:
        chosen = []
        for _ in range(self.num_ops):
            name = random.choice(self.ops)
            level = random.gauss(self.magnitude, self.mstd * _MAX_LEVEL)
            chosen.append((name, float(np.clip(level, 0, _MAX_LEVEL))))
        return chosen

    def apply(self, img, chosen: Optional[List] = None) -> np.ndarray:
        """One uint8 frame [H, W, 3] through ``chosen`` (default: a fresh
        ``sample_ops()``)."""
        img = ops.as_frames(img)
        chosen = chosen if chosen is not None else self.sample_ops()
        for name, level in chosen:
            img = _apply_op(img, name, level)
        return img

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """uint8 frames [T, H, W, 3], one op sequence per clip (the signs
        are drawn again for every frame, in frame order)."""
        chosen = self.sample_ops()
        return np.stack([self.apply(f, chosen)
                         for f in ops.as_frames(frames)])
