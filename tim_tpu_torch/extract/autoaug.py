"""Exact timm-derived RandAugment engine (draw-for-draw compatible). The
counterpart of ``tim_tpu/extract/autoaug.py``, whose ops run in PIL: here
they run on uint8 arrays through ``extract.imageops`` (Pillow's arithmetic
in numpy and host C++, no PIL); a test pins it to the original, pixel for
pixel.

The reference ships two near-identical copies of Ross Wightman's
``autoaugment.py``, with different knobs:

- Omnivore extraction (``omnivore/omnivore/datasets/autoaugment.py``):
  ops built with ``prob=1`` (a local modification, ``rand_augment_ops``
  :599-605) and an optional per-clip ``seed`` that re-seeds BOTH
  ``np.random`` and ``random`` at the start of every op application
  (``AugmentOp.__call__:324-327``). ``epickitchens.py:107-123`` builds a
  fresh transform per frame with one shared clip seed, so every frame of
  a clip receives identical randomness.
- VideoMAE finetuning (``VideoMAE/rand_augment.py``): standard timm
  semantics, ``prob=0.5`` per op, no seeding, and ``AugmentOp.__call__``
  accepts a *list* of PIL frames — one random draw per op for the whole
  clip (``rand_augment.py:345-385``).

This module implements both with a single engine whose random-draw order
is identical to the reference, so a seeded run is bit-exact against the
reference code (verified for the original in ``tests/test_autoaug.py`` by
executing both reference modules in-process). The policy-table AutoAugment / AugMix
variants present in the reference files are dead code there (no dataset
constructs them); only ``rand_augment_transform`` is reachable, and only
it is implemented here.

Draw order per op application (must not change):
  1. (seeded variant) ``np.random.seed(seed)``; ``random.seed(seed)``
  2. if ``prob < 1``: one ``random.random()`` gate
  3. if ``mstd > 0``: one ``random.gauss`` for the magnitude
  4. level resolution: at most one ``random.random()`` (sign flip)
  5. geometric ops: one ``random.choice`` over (BILINEAR, BICUBIC) per
     frame — ``_check_args_tf`` mutates only a ``**``-unpacked COPY of
     ``self.kwargs``, so the reference never caches the choice.
Op selection consumes ``np.random`` via ``np.random.choice`` exactly as
the reference's ``RandAugment.__call__`` does.
"""

from __future__ import annotations

import random
import re
from typing import Dict, Optional, Sequence

import numpy as np

from tim_tpu_torch.extract import imageops as ops

MAX_MAG = 10.0
GRAY = (128, 128, 128)

# Same order as the reference tables — op selection is by index.
RAND_TRANSFORMS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
)
RAND_INCREASING_TRANSFORMS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
)
# "experimental" choice weights (w0), keyed like RAND_TRANSFORMS
_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2,
    "TranslateXRel": 0.1, "TranslateYRel": 0.1,
    "Color": 0.025, "Sharpness": 0.025, "AutoContrast": 0.025,
    "Solarize": 0.005, "SolarizeAdd": 0.005, "Contrast": 0.005,
    "Brightness": 0.005, "Equalize": 0.005, "Posterize": 0, "Invert": 0,
}

_ENHANCE = {"Color", "Contrast", "Brightness", "Sharpness"}
_ENHANCE_INC = {n + "Increasing" for n in _ENHANCE}
_GEOMETRIC = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY",
              "TranslateXRel", "TranslateYRel"}


def _signed(v: float) -> float:
    # one random.random() draw, > (not >=), matching _randomly_negate
    return -v if random.random() > 0.5 else v


def _resolve(name: str, mag: float, hp: Dict) -> tuple:
    """Magnitude -> op arguments; the exact timm level maths."""
    f = mag / MAX_MAG
    if name == "Rotate":
        return (_signed(f * 30.0),)
    if name in _ENHANCE:
        return (f * 1.8 + 0.1,)
    if name in _ENHANCE_INC:
        return (1.0 + _signed(f * 0.9),)
    if name in ("ShearX", "ShearY"):
        return (_signed(f * 0.3),)
    if name in ("TranslateX", "TranslateY"):
        return (_signed(f * float(hp["translate_const"])),)
    if name in ("TranslateXRel", "TranslateYRel"):
        return (_signed(f * hp.get("translate_pct", 0.45)),)
    if name == "Posterize":
        return (int(f * 4),)
    if name == "PosterizeIncreasing":
        return (4 - int(f * 4),)
    if name == "PosterizeOriginal":
        return (int(f * 4) + 4,)
    if name == "Solarize":
        return (int(f * 256),)
    if name == "SolarizeIncreasing":
        return (256 - int(f * 256),)
    if name == "SolarizeAdd":
        return (int(f * 110),)
    return ()  # AutoContrast / Equalize / Invert


def _paint(frames: np.ndarray, name: str, args: tuple, kw: Dict):
    """Apply one resolved op to uint8 frames [T, H, W, 3] (``imageops``:
    Pillow's arithmetic)."""
    if name == "AutoContrast":
        return ops.autocontrast(frames)
    if name == "Equalize":
        return ops.equalize(frames)
    if name == "Invert":
        return ops.invert(frames)
    if name.startswith("Posterize"):
        bits = args[0]
        return frames if bits >= 8 else ops.posterize(frames, bits)
    if name in ("Solarize", "SolarizeIncreasing"):
        return ops.solarize(frames, args[0])
    if name == "SolarizeAdd":
        return ops.solarize_add(frames, args[0])
    if name.startswith("Color"):
        return ops.color(frames, args[0])
    if name.startswith("Contrast"):
        return ops.contrast(frames, args[0])
    if name.startswith("Brightness"):
        return ops.brightness(frames, args[0])
    if name.startswith("Sharpness"):
        return ops.sharpness(frames, args[0])

    # geometric: one interpolation draw per frame, in frame order — the
    # reference calls aug_fn(img, *args, **self.kwargs) per frame, and
    # **-unpacking copies the dict, so _check_args_tf's mutation never
    # persists
    rs = kw["resample"]
    if isinstance(rs, (list, tuple)):
        draws = np.asarray([random.choice(rs) for _ in range(len(frames))])
    else:
        draws = np.full(len(frames), rs)
    fill = kw["fillcolor"]
    h, w = frames.shape[1:3]
    v = args[0]
    out = np.empty_like(frames)
    for resample in np.unique(draws):      # the frames of each draw at once
        sel = draws == resample
        if name == "Rotate":
            out[sel] = ops.rotate(frames[sel], v, int(resample), fill)
            continue
        if name == "ShearX":
            mat = (1, v, 0, 0, 1, 0)
        elif name == "ShearY":
            mat = (1, 0, 0, v, 1, 0)
        elif name in ("TranslateX", "TranslateXRel"):
            px = v * w if name.endswith("Rel") else v
            mat = (1, 0, px, 0, 1, 0)
        else:  # TranslateY / TranslateYRel
            px = v * h if name.endswith("Rel") else v
            mat = (1, 0, 0, 0, 1, px)
        out[sel] = ops.affine(frames[sel], mat, int(resample), fill)
    return out


class ExactAugmentOp:
    """One named op; mirrors AugmentOp draw-for-draw."""

    def __init__(self, name: str, prob: float, magnitude: float,
                 hp: Dict, seed: Optional[int] = None):
        self.name = name
        self.prob = prob
        self.magnitude = magnitude
        self.hp = dict(hp)
        self.mstd = self.hp.get("magnitude_std", 0)
        self.seed = seed
        self.kw = {
            "fillcolor": self.hp.get("img_mean", GRAY),
            "resample": self.hp.get("interpolation", None),
        }
        if self.kw["resample"] is None:
            self.kw["resample"] = (ops.BILINEAR, ops.BICUBIC)

    def __call__(self, x):
        """uint8 frame [H, W, 3] or frames [T, H, W, 3] (or a list of
        frames) in; uint8 array of the same shape out."""
        x = ops.as_frames(x)
        if self.seed is not None:
            np.random.seed(self.seed)
            random.seed(self.seed)
        if self.prob < 1.0 and random.random() > self.prob:
            return x
        mag = self.magnitude
        if self.mstd and self.mstd > 0:
            mag = random.gauss(mag, self.mstd)
        mag = min(MAX_MAG, max(0.0, mag))
        args = _resolve(self.name, mag, self.hp)
        if x.ndim == 3:
            return _paint(x[None], self.name, args, self.kw)[0]
        return _paint(x, self.name, args, self.kw)


class ExactRandAugment:
    """num_layers ops chosen via np.random.choice, like the reference."""

    def __init__(self, ops: Sequence[ExactAugmentOp], num_layers: int = 2,
                 choice_weights=None):
        self.ops = list(ops)
        self.num_layers = num_layers
        self.choice_weights = choice_weights

    def __call__(self, x):
        x = ops.as_frames(x)
        picks = np.random.choice(
            len(self.ops), self.num_layers,
            replace=self.choice_weights is None, p=self.choice_weights)
        for i in picks:
            x = self.ops[int(i)](x)
        return x


def parse_rand_config(config_str: str):
    """'rand-m15-mstd0.5-inc1' -> (magnitude, num_layers, weight_idx,
    mstd, increasing); unparsable sections are skipped like the
    reference's ``len(cs) < 2: continue``."""
    magnitude, num_layers, weight_idx = MAX_MAG, 2, None
    mstd, increasing = None, False
    parts = config_str.split("-")
    assert parts[0] == "rand"
    for c in parts[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            mstd = float(val)
        elif key == "inc":
            increasing = bool(val)
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise ValueError(f"unknown RandAugment section {key!r}")
    return magnitude, num_layers, weight_idx, mstd, increasing


def rand_augment_transform(config_str: str, hparams: Optional[Dict] = None,
                           *, op_prob: float = 0.5,
                           seed: Optional[int] = None) -> ExactRandAugment:
    """Build the transform. ``op_prob=0.5`` is timm/VideoMAE; the
    Omnivore copy hardcodes ``prob=1`` — use :func:`rand_augment_omnivore`.
    ``hparams['magnitude_std']`` wins over the config's mstd (setdefault
    semantics, like the reference)."""
    hp = dict(hparams or {})
    magnitude, num_layers, weight_idx, mstd, inc = \
        parse_rand_config(config_str)
    if mstd is not None:
        hp.setdefault("magnitude_std", mstd)
    names = RAND_INCREASING_TRANSFORMS if inc else RAND_TRANSFORMS
    ops = [ExactAugmentOp(n, op_prob, magnitude, hp, seed) for n in names]
    weights = None
    if weight_idx is not None:
        assert weight_idx == 0, "only weight set 0 exists"
        w = np.asarray([_CHOICE_WEIGHTS_0[n] for n in names], np.float64)
        weights = w / w.sum()
    return ExactRandAugment(ops, num_layers, weights)


def rand_augment_omnivore(config_str: str, hparams: Optional[Dict] = None,
                          seed: Optional[int] = None) -> ExactRandAugment:
    """The Omnivore variant: every op applies (prob=1) and re-seeds from
    the clip seed (``autoaugment.py:599-605``, ``:324-327``)."""
    return rand_augment_transform(config_str, hparams,
                                  op_prob=1.0, seed=seed)


# ---------------------------------------------------------------------------
# Clip-level front doors
# ---------------------------------------------------------------------------


def omnivore_clip_augment(frames: np.ndarray, *, crop_size: int = 224,
                          mean=(0.485, 0.456, 0.406),
                          seed: Optional[int] = None) -> np.ndarray:
    """The augmentation block of ``epickitchens.py:107-125`` (identical in
    perception.py / ave.py): a FRESH ``rand-m15-mstd0.5-inc1`` transform
    per frame, all sharing one clip seed drawn from the ambient
    ``random`` state. uint8 [T, H, W, 3] in and out.

    Note the reference quirk this reproduces: because each op re-seeds
    the global RNGs, frame 0's op pair is chosen from the ambient
    ``np.random`` state but frames 1..T-1 all draw from the re-seeded
    state — so they receive one identical op pair."""
    if seed is None:
        seed = random.randint(0, 100000000)
    hp = dict(
        translate_const=int(crop_size * 0.45),
        img_mean=tuple(min(255, round(255 * m)) for m in mean),
    )
    out = []
    for f in frames:
        t = rand_augment_omnivore("rand-m15-mstd0.5-inc1", hp, seed)
        out.append(t(f))
    return np.stack(out)


class VideoRandAugment:
    """VideoMAE finetune RandAugment (``create_random_augment``,
    ``video_transforms.py:625-660``): one transform over the frame list,
    bicubic interpolation, translate_const = 0.45 * crop. uint8
    [T, H, W, 3] in and out."""

    def __init__(self, config_str: str = "rand-m7-n4-mstd0.5-inc1",
                 crop_size: int = 224, interpolation: str = "bicubic"):
        hp: Dict = {"translate_const": int(crop_size * 0.45)}
        if interpolation and interpolation != "random":
            hp["interpolation"] = {
                "bilinear": ops.BILINEAR,
                "bicubic": ops.BICUBIC,
                "lanczos": ops.LANCZOS,
                "nearest": ops.NEAREST,
            }[interpolation]
        self.transform = rand_augment_transform(config_str, hp)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        return self.transform(ops.as_frames(frames))
