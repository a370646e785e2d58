"""The port's EK100 clip dataset (``tim_tpu_torch/extract/clips.py``)
against the JAX package's on the CPU, under the same generators:

- the index samplers equal JAX's (hypothesis over the frame and segment
  counts);
- the resizes and crops without cv2 within 1e-5 of the largest value of
  JAX's cv2 functions (upscales, downscales, the 256-short-side, 224-crop
  EPIC geometry, the crop's fallback), with the same draws taken;
- ``EK100ClipDataset`` train, validation and test items equal JAX's on a
  synthetic reader (identity and default RandAugment, erasing on and off,
  DataFrame and ``dict`` annotations), pixels within 1e-5;
- ``jpeg_frame_reader`` equals JAX's (``cv2.imread``) on JPEGs written by
  cv2, an Exif-rotated frame among them, with cv2 and PIL blocked in the
  port; a validation ``EK100ClipDataset`` over the EPIC-sized frames of
  ``tests/data/torch_jpeg`` gives JAX's clips with both blocked.
"""

import os
import random
import struct
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tim_tpu.extract import clips as J
from tim_tpu_torch.extract import clips as P

cv2 = pytest.importorskip("cv2")
TOL = 1e-5       # of the largest value


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30)


@settings(max_examples=60, deadline=None, database=None)
@given(total=st.integers(1, 400), segments=st.integers(1, 32),
       test_segments=st.integers(1, 5), seed=st.integers(0, 2 ** 16))
def test_index_samplers_equal_jax(total, segments, test_segments, seed):
    np.testing.assert_array_equal(
        P.sample_train_indices(total, segments, np.random.default_rng(seed)),
        J.sample_train_indices(total, segments, np.random.default_rng(seed)))
    np.testing.assert_array_equal(P.sample_val_indices(total, segments),
                                  J.sample_val_indices(total, segments))
    np.testing.assert_array_equal(
        P.sample_test_indices(total, segments, test_segments),
        J.sample_test_indices(total, segments, test_segments))


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return P.normalize(rng.integers(0, 256, (t, h, w, 3), np.uint8))


@pytest.mark.parametrize("h,w,size", [
    (48, 64, 32), (30, 40, 256), (256, 456, 256), (64, 48, 80),
    (480, 640, 256), (7, 5, 3)])
def test_resize_short_side_and_crops_equal_cv2(h, w, size):
    frames = _frames(2, h, w)
    _close(P.resize_short_side(frames, size),
           J.resize_short_side(frames, size))
    for crop in (min(h, w) // 2, 224):
        if crop <= min(h, w):
            np.testing.assert_array_equal(P.center_crop(frames, crop),
                                          J.center_crop(frames, crop))
    out = 224 if h >= 224 else 24
    for seed in range(4):
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        _close(P.random_resized_crop(frames, out, rp),
               J.random_resized_crop(frames, out, rj))
        assert rp.integers(2 ** 31) == rj.integers(2 ** 31)   # same draws


@pytest.mark.parametrize("h,w", [(400, 20), (20, 400)])
def test_random_resized_crop_fallback_equals_cv2(h, w):
    """Frames too narrow (or wide) for any of the ten tries take the
    aspect-clamped centre crop."""
    frames = _frames(1, h, w, seed=3)
    rp, rj = np.random.default_rng(1), np.random.default_rng(1)
    _close(P.random_resized_crop(frames, 16, rp, scale=(0.9, 1.0)),
           J.random_resized_crop(frames, 16, rj, scale=(0.9, 1.0)))
    assert rp.random() == rj.random()


def test_normalize_equals_jax():
    x = np.random.default_rng(2).integers(0, 256, (2, 5, 6, 3), np.uint8)
    np.testing.assert_array_equal(P.normalize(x), J.normalize(x))


def _reader(video_id, indices, offset):
    """uint8 frames [T, 36, 52, 3] that depend on the video, the index and
    the offset."""
    return np.stack([np.random.default_rng(
        [int(video_id[1:]), int(i), int(offset)]).integers(
            0, 256, (36, 52, 3), np.uint8) for i in indices])


ANNOTATIONS = {"video_id": np.asarray(["v1", "v2", "v1"]),
               "start_frame": np.asarray([0, 5, 40]),
               "stop_frame": np.asarray([30, 9, 90]),
               "verb_class": np.asarray([3, 1, 2]),
               "noun_class": np.asarray([7, 0, 4])}


def _annotations(kind):
    if kind == "dict":
        return ANNOTATIONS
    import pandas as pd
    return pd.DataFrame(ANNOTATIONS)


def _items_equal(mod_kw, indices):
    port = P.EK100ClipDataset(rng=np.random.default_rng(5), **mod_kw[0])
    jax = J.EK100ClipDataset(rng=np.random.default_rng(5), **mod_kw[1])
    assert len(port) == len(jax)
    for i in indices:
        got_want = []
        for ds in (port, jax):
            np.random.seed(11 + i)      # VideoRandAugment's global draws
            random.seed(11 + i)
            got_want.append(ds[i])
        got, want = got_want
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "video":
                _close(got[k], want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k])
    assert port.rng.integers(2 ** 31) == jax.rng.integers(2 ** 31)


@pytest.mark.parametrize("annotations", ["dict", "dataframe"])
@pytest.mark.parametrize("augment,reprob", [("identity", 0.0),
                                            ("identity", 0.9),
                                            ("default", 0.5)])
def test_train_items_equal_jax(annotations, augment, reprob):
    kw = dict(mode="train", num_frames=4, crop_size=24, num_sample=2,
              reprob=reprob)
    port_kw = dict(kw, annotations=_annotations(annotations),
                   frame_reader=_reader)
    jax_kw = dict(kw, annotations=_annotations("dataframe"),
                  frame_reader=_reader)
    if augment == "identity":
        port_kw["rand_augment"] = jax_kw["rand_augment"] = lambda f: f
    else:
        pytest.importorskip("PIL")
    _items_equal((port_kw, jax_kw), range(3))


@pytest.mark.parametrize("mode", ["validation", "test"])
def test_validation_and_test_items_equal_jax(mode):
    kw = dict(mode=mode, num_frames=4, crop_size=24, short_side_size=32,
              test_num_segment=2, test_num_crop=3, frame_reader=_reader,
              rand_augment=lambda f: f)
    _items_equal((dict(kw, annotations=_annotations("dict")),
                  dict(kw, annotations=_annotations("dataframe"))),
                 range(3 if mode == "validation" else 18))


def _block_pil_and_cv2(monkeypatch):
    """From here on ``import cv2`` and ``import PIL`` raise (the JAX side
    has run by then)."""
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _exif6():
    """Pillow's ``exif=`` bytes: Orientation 6 (rotate 90 degrees
    clockwise), big endian."""
    ifd = (struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0)
           + struct.pack(">I", 0))
    return b"Exif\x00\x00MM" + struct.pack(">HI", 42, 8) + ifd


def test_jpeg_frame_reader_equals_jax(tmp_path, monkeypatch):
    from PIL import Image
    rng = np.random.default_rng(0)
    d = tmp_path / "v1"
    d.mkdir()
    for i in range(1, 13):
        frame = rng.integers(0, 255, (20, 28, 3), np.uint8)
        if i == 6:
            # stored 28 x 20 with Orientation 6: imread turns it to 20 x 28
            Image.fromarray(np.ascontiguousarray(
                frame.transpose(1, 0, 2)[::-1])).save(
                    d / f"img_{i:05d}.jpg", exif=_exif6())
        else:
            cv2.imwrite(str(d / f"img_{i:05d}.jpg"), frame)
    idx = np.asarray([0, 3, 7])
    want = J.jpeg_frame_reader(str(tmp_path))("v1", idx, 2)
    _block_pil_and_cv2(monkeypatch)
    got = P.jpeg_frame_reader(str(tmp_path))("v1", idx, 2)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 20, 28, 3) and got.dtype == np.uint8
    with pytest.raises(FileNotFoundError):
        P.jpeg_frame_reader(str(tmp_path))("v1", np.asarray([20]), 0)


def test_jpeg_frame_reader_runs_without_cv2_or_pil(monkeypatch):
    """Validation clips of the EPIC-sized fixture frames through the port's
    reader with cv2 and PIL blocked equal JAX's through ``cv2.imread``."""
    frames = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "torch_jpeg", "frames")
    annotations = {"video_id": np.asarray(["P01_01", "P02_03", "P01_01"]),
                   "start_frame": np.asarray([0, 2, 5]),
                   "stop_frame": np.asarray([11, 9, 6]),
                   "verb_class": np.asarray([3, 1, 2]),
                   "noun_class": np.asarray([7, 0, 4])}
    kw = dict(annotations=annotations, mode="validation", num_frames=4,
              crop_size=24, short_side_size=32, rand_augment=lambda f: f)
    tmpl = "frame_{:010d}.jpg"
    jax = J.EK100ClipDataset(
        frame_reader=J.jpeg_frame_reader(frames, tmpl), **kw)
    want = [jax[i] for i in range(3)]
    _block_pil_and_cv2(monkeypatch)
    port = P.EK100ClipDataset(
        frame_reader=P.jpeg_frame_reader(frames, tmpl), **kw)
    for i in range(3):
        got = port[i]
        assert sorted(got) == sorted(want[i])
        for k in want[i]:
            if k == "video":
                _close(got[k], want[i][k])
            else:
                np.testing.assert_array_equal(got[k], want[i][k])
