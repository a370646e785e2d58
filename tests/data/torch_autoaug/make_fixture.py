"""RandAugment's ops as Pillow computes them, for the port's
``tim_tpu_torch.extract.imageops`` and the RandAugment engines over it
(``extract.autoaug``).

Rewrite the fixture from the repository's root (needs PIL and the JAX
package's engine, ``tim_tpu.extract.autoaug``, which applies every op
through Pillow)::

    JAX_PLATFORMS=cpu python tests/data/torch_autoaug/make_fixture.py

``digests.json``, next to this script, holds no pixels: for every case the
SHA-256 digest of the uint8 result's C-order bytes, and each result's
shape. The cases (``cases()``, ``clip_cases()``):

- one op, ``ExactAugmentOp(name, 1.0, magnitude, hp)``, of every name of
  ``OPS`` at magnitudes 0, 5 and 10 and at one draw of magnitude 7 with
  std 0.5, on each frame of ``frames()``: three EPIC frames of
  ``tests/data/torch_jpeg`` (456 x 256, Pillow's decode) and two seeded
  odd ones (17 x 9 and 1 x 33, width x height); the geometric ops at
  NEAREST, BILINEAR and BICUBIC, each with the grey fill and the ImageNet
  mean's; ``random`` and ``np.random`` seeded with the case's index first;
- ``omnivore_clip_augment`` of a 32-frame clip of the EPIC frames (its
  geometric ops draw BILINEAR or BICUBIC per frame) and
  ``VideoRandAugment("rand-m7-n4-mstd0.5-inc1", interpolation="bicubic")``
  of a 16-frame one, each under three seeds.

Everything here but ``main`` needs numpy alone, so ``chip_smoke.py``
phase 30 holds the port to the digests where PIL is not installed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "torch_jpeg")
DIGESTS = os.path.join(HERE, "digests.json")

# tests/test_torch_autoaug.py::OPS
OPS = ("AutoContrast", "Brightness", "BrightnessIncreasing", "Color",
       "ColorIncreasing", "Contrast", "ContrastIncreasing", "Equalize",
       "Invert", "Posterize", "PosterizeIncreasing", "PosterizeOriginal",
       "Rotate", "Sharpness", "SharpnessIncreasing", "ShearX", "ShearY",
       "Solarize", "SolarizeAdd", "SolarizeIncreasing", "TranslateX",
       "TranslateXRel", "TranslateY", "TranslateYRel")
GEOMETRIC = ("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateXRel",
             "TranslateY", "TranslateYRel")
# label -> (magnitude, magnitude_std)
MAGNITUDES = {"m0": (0.0, 0.0), "m5": (5.0, 0.0), "m10": (10.0, 0.0),
              "m7s0.5": (7.0, 0.5)}
RESAMPLES = {"nearest": 0, "bilinear": 2, "bicubic": 3}   # Pillow's codes
FILLS = {"grey": (128, 128, 128), "imagenet": (124, 116, 104)}
TRANSLATE_CONST = 100                                      # int(224 * 0.45)
# name -> (video, frame number) of tests/data/torch_jpeg, or a seeded size
EPIC_FRAMES = {"epic0": ("P01_01", 1), "epic1": ("P01_01", 7),
               "epic2": ("P02_03", 4)}
ODD_FRAMES = {"odd_17x9": (9, 17), "odd_1x33": (33, 1)}    # (H, W)
CLIP_SEEDS = (0, 1, 2)
CLIP_FRAMES = {"omnivore_clip": 32, "video_rand_augment": 16}


def jpeg_fixture():
    """``tests/data/torch_jpeg/make_fixture.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_fixture", os.path.join(JPEG_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def epic_paths() -> list:
    """The EPIC frame files of ``tests/data/torch_jpeg``, in order."""
    return [p for ps in jpeg_fixture().frame_paths().values() for p in ps]


def frame_path(name: str) -> str:
    video, number = EPIC_FRAMES[name]
    return os.path.join(JPEG_DIR, "frames", video, f"frame_{number:010d}.jpg")


def frames(read) -> dict:
    """name -> uint8 [H, W, 3]: ``read(path)`` (Pillow's decode, or the
    port's) of each EPIC frame, then the seeded odd frames."""
    out = {name: read(frame_path(name)) for name in EPIC_FRAMES}
    for name, shape in ODD_FRAMES.items():
        out[name] = np.random.default_rng(shape[0] * 100 + shape[1]).integers(
            0, 256, shape + (3,), dtype=np.uint8)
    return out


def clip(epic: list, n: int) -> np.ndarray:
    """``n`` frames of the decoded EPIC frames, cycled."""
    return np.stack([epic[i % len(epic)] for i in range(n)])


def cases() -> list:
    """Every single-op case, in order: dicts of key, frame, op, magnitude,
    mstd, resample, fill, seed."""
    out = []
    for frame in list(EPIC_FRAMES) + list(ODD_FRAMES):
        for op in OPS:
            for label, (magnitude, mstd) in MAGNITUDES.items():
                kinds = ([(r, f) for r in RESAMPLES for f in FILLS]
                         if op in GEOMETRIC else [(None, "grey")])
                for resample, fill in kinds:
                    key = "/".join([frame, op, label]
                                   + ([resample, fill] if resample else []))
                    out.append(dict(key=key, frame=frame, op=op,
                                    magnitude=magnitude, mstd=mstd,
                                    resample=resample, fill=fill,
                                    seed=len(out)))
    return out


def hparams(case: dict) -> dict:
    hp = {"translate_const": TRANSLATE_CONST,
          "img_mean": FILLS[case["fill"]]}
    if case["resample"]:
        hp["interpolation"] = RESAMPLES[case["resample"]]
    if case["mstd"]:
        hp["magnitude_std"] = case["mstd"]
    return hp


def run_case(engine, image, case: dict):
    """One case through ``engine`` (an ``autoaug`` module) on ``image`` (a
    frame as that engine takes it)."""
    random.seed(case["seed"])
    np.random.seed(case["seed"])
    return engine.ExactAugmentOp(case["op"], 1.0, case["magnitude"],
                                 hparams(case))(image)


def clip_cases() -> list:
    """(key, front door, seed) of the clip cases."""
    return [(f"{door}/seed{seed}", door, seed)
            for door in CLIP_FRAMES for seed in CLIP_SEEDS]


def run_clip(engine, epic: list, door: str, seed: int) -> np.ndarray:
    """A clip case through ``engine``'s front door, ``random`` and
    ``np.random`` seeded first."""
    frames_ = clip(epic, CLIP_FRAMES[door])
    random.seed(seed)
    np.random.seed(seed + 1)
    if door == "omnivore_clip":
        return engine.omnivore_clip_augment(frames_)
    return engine.VideoRandAugment("rand-m7-n4-mstd0.5-inc1",
                                   interpolation="bicubic")(frames_)


def digest(array: np.ndarray) -> str:
    """SHA-256 hex digest of a uint8 array's C-order bytes."""
    return hashlib.sha256(
        np.ascontiguousarray(array, np.uint8).tobytes()).hexdigest()


def read_digests() -> dict:
    """{"pillow": version, "shapes": {key: shape}, "digests": {key: hex}};
    a single-op case's shape is its frame's (under the frame's name)."""
    with open(DIGESTS) as f:
        out = json.load(f)
    out["shapes"] = {k: tuple(v) for k, v in out["shapes"].items()}
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    import PIL
    from PIL import Image

    from tim_tpu.extract import autoaug

    def pil_read(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    frames_ = frames(pil_read)
    shapes = {name: list(a.shape) for name, a in frames_.items()}
    digests = {}
    for case in cases():
        out = np.asarray(run_case(autoaug, Image.fromarray(
            frames_[case["frame"]]), case))
        assert out.shape == frames_[case["frame"]].shape, case
        digests[case["key"]] = digest(out)
    epic = [pil_read(p) for p in epic_paths()]
    for key, door, seed in clip_cases():
        out = run_clip(autoaug, epic, door, seed)
        shapes[key] = list(out.shape)
        digests[key] = digest(out)
    with open(DIGESTS, "w") as f:
        json.dump({"pillow": PIL.__version__, "shapes": shapes,
                   "digests": digests}, f, indent=0, sort_keys=True)
        f.write("\n")
    print(f"{len(digests)} digests -> {DIGESTS} ({os.path.getsize(DIGESTS)} "
          f"bytes)")


if __name__ == "__main__":
    main()
