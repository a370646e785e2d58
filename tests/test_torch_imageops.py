"""The port's Pillow ops (``tim_tpu_torch/extract/imageops.py``, its C++
loops in ``csrc/host/imageops.cc``) and the RandAugment engines over them
(``extract/autoaug.py``, ``extract/augment.py``) against Pillow, bit for
bit, on the CPU:

- every op name of ``tests/test_torch_autoaug.py::OPS`` at magnitudes 0, 5
  and 10 and one draw of magnitude 7 with std 0.5, the geometric ops at
  NEAREST, BILINEAR and BICUBIC with the grey and the ImageNet-mean fill,
  on 48 x 48 frames and two odd sizes (17 x 9, 1 x 33), equal to the JAX
  package's engine (``tim_tpu.extract.autoaug.ExactAugmentOp`` on PIL
  images, that is Pillow) with 0 mismatching bytes;
- ``affine`` and ``smooth`` (C++) equal their numpy twins
  (``affine_plain``, ``smooth_plain``) on each of libImaging's routes;
- edge cases against Pillow: constant frames and bands (autocontrast's and
  equalize's identity tables), rotations by 0, +-30, 90, 180 and 270
  degrees, a shear that sends every pixel outside (all fill), enhancement
  factors 0, 1 and outside [0, 1], the resample codes Pillow refuses;
- the front doors (``omnivore_clip_augment``, ``VideoRandAugment`` at
  every interpolation, ``augment.RandAugment``) equal JAX's under the same
  seeds with PIL and cv2 blocked in ``sys.modules`` for the port's run;
- ``tests/data/torch_autoaug``'s digests (Pillow's results on EPIC
  frames, which ``chip_smoke.py`` phase 30 reads) equal the port's.
"""

import importlib.util
import os
import random
import sys

import numpy as np
import pytest

from tim_tpu_torch.extract import augment as paugment
from tim_tpu_torch.extract import autoaug as paug
from tim_tpu_torch.extract import imageops as O
from tim_tpu_torch.utils import jpeg as J

Image = pytest.importorskip("PIL.Image")
from PIL import ImageEnhance, ImageFilter, ImageOps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREY, IMAGENET = (128, 128, 128), (124, 116, 104)


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "torch_autoaug_fixture",
        os.path.join(ROOT, "tests", "data", "torch_autoaug", "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FX = _fixture_module()


def _smooth_content(h, w, seed):
    """Waves and a flat box: uneven histograms, saturated corners."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 140 * np.sin(rng.uniform(0.05, 0.3) * x
                                       + rng.uniform(0.05, 0.3) * y + c)
                    for c in range(3)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


FRAMES = {
    "noise48": np.random.default_rng(0).integers(0, 256, (48, 48, 3),
                                                 dtype=np.uint8),
    "smooth48": _smooth_content(48, 48, 1),
    "odd_17x9": np.random.default_rng(2).integers(0, 256, (9, 17, 3),
                                                  dtype=np.uint8),
    "odd_1x33": np.random.default_rng(3).integers(0, 256, (33, 1, 3),
                                                  dtype=np.uint8),
}


@pytest.fixture(scope="module")
def jaug():
    """The JAX package's engine (Pillow under it), one per module."""
    from tim_tpu.extract import autoaug
    return autoaug


@pytest.fixture(scope="module")
def jaugment():
    from tim_tpu.extract import augment
    return augment


@pytest.fixture(scope="module")
def lib():
    return J.library()


def _blocked(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_fixture_ops_are_the_autoaug_tests_ops():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from test_torch_autoaug import OPS
    finally:
        sys.path.pop(0)
    assert list(FX.OPS) == OPS
    assert set(FX.GEOMETRIC) == {n for n in OPS if n in paug._GEOMETRIC}


@pytest.mark.parametrize("name", FX.OPS)
def test_op_equals_pillow_through_jax_engine(jaug, lib, name):
    """Every magnitude, resample and fill on every frame: 0 bytes differ."""
    kinds = ([(r, f) for r in FX.RESAMPLES.values() for f in (GREY, IMAGENET)]
             if name in FX.GEOMETRIC else [(None, GREY)])
    checked = 0
    for frame_name, frame in FRAMES.items():
        for label, (magnitude, mstd) in FX.MAGNITUDES.items():
            for resample, fill in kinds:
                hp = {"translate_const": 21, "img_mean": fill}
                if resample is not None:
                    hp["interpolation"] = resample
                if mstd:
                    hp["magnitude_std"] = mstd
                seed = checked
                random.seed(seed)
                np.random.seed(seed)
                want = np.asarray(jaug.ExactAugmentOp(
                    name, 1.0, magnitude, dict(hp))(Image.fromarray(frame)))
                random.seed(seed)
                np.random.seed(seed)
                got = paug.ExactAugmentOp(name, 1.0, magnitude,
                                          dict(hp))(frame)
                assert got.dtype == np.uint8 and got.shape == want.shape
                bad = int((got != want).sum())
                assert bad == 0, (f"{name} {frame_name} {label} resample "
                                  f"{resample} fill {fill}: {bad} bytes")
                checked += 1
    assert checked == len(FRAMES) * len(FX.MAGNITUDES) * len(kinds)


# affine matrices: each of libImaging's routes
MATRICES = {
    "shear_x": (1, 0.3, 0, 0, 1, 0),
    "shear_y": (1, 0, 0, -0.27, 1, 0),
    "translate": (1, 0, 7.5, 0, 1, -3.25),          # NEAREST: scale table
    "scale": (0.5, 0, 3, 0, 1.7, -2),
    "rotate_30": tuple(O.rotation_matrix(40, 24, 30.0)),
    "rotate_-30": tuple(O.rotation_matrix(40, 24, -30.0 % 360.0)),
    "general": (0.9, -0.4, 5.5, 0.35, 1.1, -6.0),
    "far": (1, 0.1, 40000.0, 0.0001, 1, 0),          # NEAREST: double loop
    "all_outside": (1, 0.3, 1000, 0, 1, 0),
}


@pytest.mark.parametrize("resample", [O.NEAREST, O.BILINEAR, O.BICUBIC])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_affine_equals_its_plain_twin_and_pillow(lib, matrix, resample):
    m = MATRICES[matrix]
    clip = np.stack([_smooth_content(24, 40, 4), FRAMES["noise48"][:24, :40],
                     _smooth_content(24, 40, 5)])
    got = O.affine(clip, m, resample, IMAGENET)
    np.testing.assert_array_equal(got, O.affine_plain(clip, m, resample,
                                                      IMAGENET))
    for f, g in zip(clip, got):
        want = np.asarray(Image.fromarray(f).transform(
            (40, 24), Image.AFFINE, m, resample=resample, fillcolor=IMAGENET))
        np.testing.assert_array_equal(g, want)
    if matrix == "all_outside":
        assert (got == np.asarray(IMAGENET, np.uint8)).all()


def test_affine_double_loop_route_equals_pillow(lib):
    """Corners past +-32768: NEAREST leaves 16.16 fixed point for its
    double loop (a frame 40,000 pixels wide)."""
    wide = np.random.default_rng(6).integers(0, 256, (3, 40000, 3), np.uint8)
    for m in ((1, 0.1, 0, 0.0001, 1, 0), (1, 0.5, -3, 0.00005, 1, 0.2)):
        want = np.asarray(Image.fromarray(wide).transform(
            (40000, 3), Image.AFFINE, m, resample=0, fillcolor=(1, 2, 3)))
        np.testing.assert_array_equal(O.affine(wide, m, 0, (1, 2, 3)), want)
        np.testing.assert_array_equal(O.affine_plain(wide, m, 0, (1, 2, 3)),
                                      want)


@pytest.mark.parametrize("shape", [(24, 40), (3, 3), (2, 7), (9, 1), (1, 1)])
def test_smooth_equals_its_plain_twin_and_pillow(lib, shape):
    clip = np.stack([_smooth_content(*shape, s) for s in range(2)]
                    + [FRAMES["noise48"][:shape[0], :shape[1]]])
    got = O.smooth(clip)
    np.testing.assert_array_equal(got, O.smooth_plain(clip))
    for f, g in zip(clip, got):
        np.testing.assert_array_equal(
            g, np.asarray(Image.fromarray(f).filter(ImageFilter.SMOOTH)))


@pytest.mark.parametrize("angle", [0, 30, -30, 90, 180, 270, -90, 360, 45.5,
                                   1e-14])
def test_rotate_equals_pillow(lib, monkeypatch, angle):
    """Pillow's shortcuts (copy, transposes; 90 and 270 only on squares)
    and its 15-digit matrix otherwise, on a square and an oblong frame,
    through the C++ loop and through its numpy twin."""
    cases = [(f, r) for f in (FRAMES["smooth48"], FRAMES["odd_17x9"])
             for r in (O.NEAREST, O.BILINEAR, O.BICUBIC)]
    want = [np.asarray(Image.fromarray(f).rotate(angle, resample=r,
                                                 fillcolor=GREY))
            for f, r in cases]
    for route in (O.affine, O.affine_plain):
        monkeypatch.setattr(O, "affine", route)
        for (frame, resample), w in zip(cases, want):
            np.testing.assert_array_equal(
                O.rotate(frame, angle, resample, GREY), w)


@pytest.mark.parametrize("resample", [O.LANCZOS, O.BOX, O.HAMMING, 7])
def test_refused_resamples_raise_as_pillow(lib, resample):
    frame = FRAMES["smooth48"]
    with pytest.raises(ValueError) as pil:
        Image.fromarray(frame).transform((48, 48), Image.AFFINE,
                                         (1, 0.2, 0, 0, 1, 0),
                                         resample=resample)
    for fn in (O.affine, O.affine_plain):
        with pytest.raises(ValueError) as port:
            fn(frame, (1, 0.2, 0, 0, 1, 0), resample)
        assert str(port.value) == str(pil.value)
    with pytest.raises(ValueError):
        O.rotate(frame, 30, resample)
    # rotate's shortcuts come before Pillow's check
    for angle in (0, 180, 90):
        np.testing.assert_array_equal(
            O.rotate(frame, angle, resample),
            np.asarray(Image.fromarray(frame).rotate(angle,
                                                     resample=resample)))


def _constant_cases():
    flat = np.full((12, 10, 3), 77, np.uint8)
    band = FRAMES["noise48"][:12, :10].copy()
    band[..., 1] = 200
    two = np.where(FRAMES["noise48"][:12, :10] > 127, 250, 3).astype(np.uint8)
    nearly = flat.copy()
    nearly[0, 0] = 78                     # equalize's step 0
    return {"flat": flat, "band": band, "two_values": two, "nearly": nearly}


@pytest.mark.parametrize("case", list(_constant_cases()))
def test_histogram_ops_on_constant_frames_and_bands(case):
    frame = _constant_cases()[case]
    im = Image.fromarray(frame)
    np.testing.assert_array_equal(O.autocontrast(frame),
                                  np.asarray(ImageOps.autocontrast(im)))
    np.testing.assert_array_equal(O.equalize(frame),
                                  np.asarray(ImageOps.equalize(im)))
    for factor in (0.0, 0.5, 1.9):
        np.testing.assert_array_equal(
            O.contrast(frame, factor),
            np.asarray(ImageEnhance.Contrast(im).enhance(factor)))
    if case == "flat":
        np.testing.assert_array_equal(O.autocontrast(frame), frame)
        np.testing.assert_array_equal(O.equalize(frame), frame)


ENHANCERS = {"color": (O.color, ImageEnhance.Color),
             "contrast": (O.contrast, ImageEnhance.Contrast),
             "brightness": (O.brightness, ImageEnhance.Brightness),
             "sharpness": (O.sharpness, ImageEnhance.Sharpness)}


@pytest.mark.parametrize("name", list(ENHANCERS))
def test_enhancers_at_every_kind_of_factor(lib, name):
    """0 and 1 (copies), inside (truncated), outside (clipped), and factors
    whose C float rounds to 0 or 1."""
    port, pil = ENHANCERS[name]
    for frame in FRAMES.values():
        for factor in (0.0, 1.0, 0.1, 0.5, 0.999, 1.9, 2.5, -0.3, -1.0,
                       1e-9, 1 - 1e-9, 1 + 1e-9, 0.1 + 0.9):
            np.testing.assert_array_equal(
                port(frame, factor),
                np.asarray(pil(Image.fromarray(frame)).enhance(factor)),
                err_msg=f"{name} {factor}")


def test_blend_is_pillows_on_every_pair_of_values():
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                indexing="ij"), -1).astype(np.uint8)
    a = np.repeat(grid[..., :1], 3, -1)
    b = np.repeat(grid[..., 1:], 3, -1)
    for factor in (0.3, 0.7777, 1.4, -0.6):
        want = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b),
                                      factor))
        np.testing.assert_array_equal(O.blend(a, b, factor), want)


def test_point_ops_and_to_l_equal_pillow():
    frame = FRAMES["smooth48"]
    im = Image.fromarray(frame)
    np.testing.assert_array_equal(O.to_l(frame), np.asarray(im.convert("L")))
    np.testing.assert_array_equal(O.invert(frame),
                                  np.asarray(ImageOps.invert(im)))
    for bits in range(9):
        np.testing.assert_array_equal(
            O.posterize(frame, bits), np.asarray(ImageOps.posterize(im, bits)))
    for threshold in (0, 1, 128, 255, 256):
        np.testing.assert_array_equal(
            O.solarize(frame, threshold),
            np.asarray(ImageOps.solarize(im, threshold)))


@pytest.mark.parametrize("add", [-300, -5, 0, 1, 55, 110, 127, 300])
def test_solarize_add_is_both_engines_variants(jaug, add):
    """timm's table through ``point`` (``autoaug``) and ``augment``'s
    ``np.where`` give the same bytes for every integer add."""
    frame = FRAMES["smooth48"]
    lut = [min(255, i + add) if i < 128 else i for i in range(256)]
    table = np.asarray(Image.fromarray(frame).point(lut * 3))
    arr = frame.astype(np.int32)
    where = np.where(arr < 128, np.clip(arr + add, 0, 255), arr).astype(
        np.uint8)
    np.testing.assert_array_equal(table, where)
    np.testing.assert_array_equal(O.solarize_add(frame, add), table)


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed + 1)
    return fn()


def test_omnivore_clip_augment_equals_jax_without_pil(jaug, lib, monkeypatch):
    clip = np.stack([_smooth_content(40, 56, s) for s in range(5)])
    clip[3] = FRAMES["noise48"][:40, :48].repeat(2, 1)[:, :56]
    want = [_seeded(s, lambda: jaug.omnivore_clip_augment(clip, crop_size=40))
            for s in range(6)]
    _blocked(monkeypatch)
    for s in range(6):
        got = _seeded(s, lambda: paug.omnivore_clip_augment(clip,
                                                            crop_size=40))
        np.testing.assert_array_equal(got, want[s])


@pytest.mark.parametrize("interpolation", ["bicubic", "random", "bilinear",
                                           "nearest", "lanczos"])
def test_video_rand_augment_equals_jax_without_pil(jaug, lib, monkeypatch,
                                                   interpolation):
    """Pillow refuses LANCZOS in ``transform``: both engines raise the same
    ``ValueError`` on the same draws, and agree wherever no geometric op
    is drawn."""
    clip = np.stack([_smooth_content(32, 44, s + 10) for s in range(4)])

    def run(engine, trial):
        try:
            return _seeded(trial, lambda: engine.VideoRandAugment(
                "rand-m7-n4-mstd0.5-inc1", crop_size=32,
                interpolation=interpolation)(clip))
        except ValueError as e:
            return str(e)

    want = [run(jaug, t) for t in range(10)]
    _blocked(monkeypatch)
    got = [run(paug, t) for t in range(10)]
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    refused = sum(isinstance(w, str) for w in want)
    assert (refused > 0) == (interpolation == "lanczos"), refused


def test_augment_rand_augment_equals_jax_without_pil(jaugment, lib,
                                                     monkeypatch):
    clip = np.stack([_smooth_content(30, 36, s + 20) for s in range(3)])
    configs = [dict(), dict(magnitude=9, num_ops=4),
               dict(magnitude=5, num_ops=3, mstd=0.0)]
    want = [[_seeded(t, lambda: jaugment.RandAugment(**kw)(clip))
             for t in range(8)] for kw in configs]
    _blocked(monkeypatch)
    for kw, ws in zip(configs, want):
        for t, w in enumerate(ws):
            got = _seeded(t, lambda: paugment.RandAugment(**kw)(clip))
            np.testing.assert_array_equal(got, w, err_msg=f"{kw} {t}")


def test_fixture_digests_equal_the_port(lib, monkeypatch):
    """Every single-op case and clip case of ``tests/data/torch_autoaug``
    (Pillow's results through the JAX engine) equals the port's, with PIL
    and cv2 blocked."""
    _blocked(monkeypatch)
    fixture = FX.read_digests()
    frames = FX.frames(lambda p: J.read_jpeg(p, apply_orientation=False))
    assert {k: tuple(v.shape) for k, v in frames.items()} == {
        k: v for k, v in fixture["shapes"].items() if k in frames}
    cases = FX.cases()
    assert len(cases) + len(FX.clip_cases()) == len(fixture["digests"])
    bad = [c["key"] for c in cases
           if FX.digest(FX.run_case(paug, frames[c["frame"]], c))
           != fixture["digests"][c["key"]]]
    epic = [J.read_jpeg(p, apply_orientation=False) for p in FX.epic_paths()]
    for key, door, seed in FX.clip_cases():
        out = FX.run_clip(paug, epic, door, seed)
        if (out.shape != fixture["shapes"][key]
                or FX.digest(out) != fixture["digests"][key]):
            bad.append(key)
    assert not bad, bad


def test_ops_take_frames_clips_and_lists(lib):
    """A clip is each frame alone; a list of frames is stacked; other
    arrays are refused."""
    clip = np.stack([_smooth_content(16, 20, s) for s in range(3)])
    for fn in (O.autocontrast, O.equalize, O.smooth,
               lambda x: O.contrast(x, 0.4),
               lambda x: O.affine(x, (1, 0.2, 1, 0, 1, 0), O.BICUBIC, GREY),
               lambda x: O.rotate(x, 20, O.BILINEAR)):
        whole = fn(clip)
        np.testing.assert_array_equal(whole, np.stack([fn(f) for f in clip]))
        np.testing.assert_array_equal(fn(list(clip)), whole)
    for bad in (clip.astype(np.float32), clip[..., :2], clip[0, 0]):
        with pytest.raises(ValueError, match="uint8 RGB"):
            O.equalize(bad)


def test_no_compiler_raises(monkeypatch, tmp_path):
    """No g++ and no built library: the C++ loops raise ``RuntimeError``
    naming g++; the ops have no other route."""
    monkeypatch.setattr(J, "_lib", None)
    monkeypatch.setattr(J, "_LIB", str(tmp_path / "libtimjpeg.so"))
    monkeypatch.setattr(J.shutil, "which", lambda name: None)
    frame = FRAMES["smooth48"]
    for fn in (O.smooth, lambda x: O.affine(x, (1, 0.1, 0, 0, 1, 0)),
               lambda x: O.sharpness(x, 0.5)):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            fn(frame)
