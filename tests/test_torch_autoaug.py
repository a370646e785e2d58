"""``tim_tpu_torch/extract/autoaug.py`` is a copy of
``tim_tpu/extract/autoaug.py`` (the RandAugment engine of the extraction
CLI's augmentation sets), pinned to it pixel for pixel under the same
seeds of ``random`` and ``np.random``: every op at three magnitudes, the
Omnivore per-frame block (``omnivore_clip_augment``), the VideoMAE clip
transform (``VideoRandAugment``, fixed and random interpolation, the
weighted op choice) and the config parser. ``tests/test_autoaug.py``
holds the original to the reference's code where that tree exists."""

import random

import numpy as np
import pytest
from PIL import Image

from tim_tpu.extract import autoaug as jaug
from tim_tpu_torch.extract import autoaug as paug

HP = dict(translate_const=21, img_mean=(128, 128, 128))
OPS = sorted(set(jaug.RAND_TRANSFORMS) | set(jaug.RAND_INCREASING_TRANSFORMS)
             | {"PosterizeOriginal", "TranslateX", "TranslateY"})


def _image(seed, size=48):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                dtype=np.uint8)


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed + 1)
    return fn()


def test_op_tables_equal_jax():
    assert paug.RAND_TRANSFORMS == jaug.RAND_TRANSFORMS
    assert paug.RAND_INCREASING_TRANSFORMS == jaug.RAND_INCREASING_TRANSFORMS
    for config in ("rand-m7-n4-mstd0.5-inc1", "rand-m15-mstd0.5-inc1",
                   "rand-m9-mstd0.5-w0"):
        assert paug.parse_rand_config(config) == \
            jaug.parse_rand_config(config)


@pytest.mark.parametrize("name", OPS)
def test_every_op_equal_jax(name):
    img = Image.fromarray(_image(7))
    for i, mag in enumerate((0.0, 5.0, 10.0)):
        seed = OPS.index(name) * 10 + i
        want = _seeded(seed, lambda: np.asarray(
            jaug.ExactAugmentOp(name, 1.0, mag, dict(HP))(img)))
        got = _seeded(seed, lambda: np.asarray(
            paug.ExactAugmentOp(name, 1.0, mag, dict(HP))(img)))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} m{mag}")


def test_omnivore_clip_augment_equal_jax():
    frames = np.stack([_image(i) for i in range(4)])
    frames[2] = frames[1]
    for ambient in range(6):
        want = _seeded(ambient, lambda: jaug.omnivore_clip_augment(
            frames, crop_size=48, mean=(0.485, 0.456, 0.406)))
        got = _seeded(ambient, lambda: paug.omnivore_clip_augment(
            frames, crop_size=48, mean=(0.485, 0.456, 0.406)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("config,interpolation", [
    ("rand-m7-n4-mstd0.5-inc1", "bicubic"),     # the extraction CLI's
    ("rand-m7-n4-mstd0.5-inc1", "random"),
    ("rand-m9-mstd0.5-w0", "bilinear"),
])
def test_video_rand_augment_equal_jax(config, interpolation):
    frames = np.stack([_image(i + 10) for i in range(3)])
    for trial in range(8):
        want = _seeded(trial, lambda: jaug.VideoRandAugment(
            config, crop_size=48, interpolation=interpolation)(frames))
        got = _seeded(trial, lambda: paug.VideoRandAugment(
            config, crop_size=48, interpolation=interpolation)(frames))
        np.testing.assert_array_equal(got, want)
