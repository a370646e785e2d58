"""The port's JPEG decoder (``tim_tpu_torch/utils/jpeg.py`` over
``csrc/host/jpeg.cc``) and its uint8 resizes
(``tim_tpu_torch/extract/image.py``) against Pillow and OpenCV, bit for bit,
on the CPU:

- every file of ``tests/data/torch_jpeg`` (EPIC-sized 4:2:0 frames; 4:4:4,
  4:2:2, 4:4:0, 4:1:1; grayscale; odd sizes down to 1 x 1; qualities 100
  and 5; optimised tables; restart markers by rows and blocks; progressive
  with and without subsampling and with restarts; RGB by component ids
  and by an Adobe marker; Exif Orientation 1-8 in both byte orders) decodes
  to Pillow's pixels without the orientation and to ``cv2.imread``'s with
  it, and both decodes and both resizes equal the file's ``.npz`` twin;
- ``resize_pil_bilinear_u8`` equals ``Image.resize(BILINEAR)`` and
  ``resize_cv2_linear_u8`` equals ``cv2.resize(..., fx, fy)`` on sizes and
  scales drawn by hypothesis (1 to 512, up and down; cv2's 2x INTER_AREA
  route included) and at EPIC's 256 x 456 -> 224; the numpy versions equal
  the C++ loops;
- files the decoder does not read are refused, naming the marker or the
  offset: lossless, arithmetic-coded, 12-bit, CMYK, a missing table, a
  truncated file, a missing EOI, bytes that are not a JPEG; every
  single-byte flip inside an EPIC frame's scan either raises
  ``ValueError`` or decodes to other pixels (JPEG has no checksum), never
  anything else;
- ``read_jpegs`` equals ``read_jpeg`` frame by frame, names a missing file,
  refuses frames of two sizes, and a host without ``g++`` raises
  ``RuntimeError``.
"""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tim_tpu_torch.extract import image as I
from tim_tpu_torch.utils import jpeg as J

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "torch_jpeg")


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_fixture", os.path.join(FIXTURE_DIR, "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FX = _fixture_module()
FILES = [os.path.relpath(p, FIXTURE_DIR) for p in FX.jpeg_files()]


@pytest.fixture(scope="module")
def lib():
    """The host library, built once for the module."""
    return J.library()


def _pil(path_or_bytes):
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"))


def _cv2(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("name", FILES)
def test_fixture_file_equals_pil_cv2_and_its_twin(lib, name):
    path = os.path.join(FIXTURE_DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    plain = J.read_jpeg(path, apply_orientation=False)
    oriented = J.read_jpeg(path, apply_orientation=True)
    np.testing.assert_array_equal(plain, _pil(path))
    np.testing.assert_array_equal(oriented, _cv2(data))
    np.testing.assert_array_equal(J.decode_jpeg(data, apply_orientation=True),
                                  oriented)
    assert plain.dtype == np.uint8 and plain.flags.c_contiguous
    width, height = FX.pil_resize_size(*plain.shape[:2])
    scale = FX.cv2_scale(plain.shape[0])
    got = {"pil": plain, "cv2": oriented,
           "pil_resize": I.resize_pil_bilinear_u8(plain[None], width,
                                                  height)[0],
           "cv2_resize": I.resize_cv2_linear_u8(plain[None], scale,
                                                scale)[0]}
    twin = FX.read_twin(path)
    for key in FX.TWIN_KEYS:
        assert FX.digest(got[key]) == twin[key], key


def test_fixture_covers_the_orientations_and_color_spaces(lib):
    """The Exif files rotate under cv2's semantics only, and the RGB-marked
    files decode without the YCbCr transform (Pillow agrees)."""
    for o in range(1, 9):
        path = os.path.join(FIXTURE_DIR, "images", f"exif_{o}.jpg")
        plain = J.read_jpeg(path, apply_orientation=False)
        oriented = J.read_jpeg(path, apply_orientation=True)
        assert plain.shape == (24, 40, 3)
        assert oriented.shape == ((40, 24, 3) if o >= 5 else (24, 40, 3))
        expect = {1: plain, 2: plain[:, ::-1], 3: plain[::-1, ::-1],
                  4: plain[::-1], 5: plain.transpose(1, 0, 2),
                  6: plain.transpose(1, 0, 2)[:, ::-1],
                  7: plain[::-1, ::-1].transpose(1, 0, 2),
                  8: plain.transpose(1, 0, 2)[::-1]}[o]
        np.testing.assert_array_equal(oriented, expect)
    for name in ("rgb_ids.jpg", "rgb_adobe.jpg"):
        path = os.path.join(FIXTURE_DIR, "images", name)
        with open(path, "rb") as f:
            data = f.read()
        assert b"JFIF" not in data[:40]
        with Image.open(path) as im:
            assert im.mode == "RGB"


def _frames(rng, t, h, w):
    """Smooth frames with texture (resizes of pure noise hide no tap)."""
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x * rng.uniform(0.02, 0.4)
                             + y * rng.uniform(0.02, 0.4))[..., None]
    noise = rng.integers(-40, 40, (t, h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 512), w=st.integers(1, 512),
       oh=st.integers(1, 512), ow=st.integers(1, 512),
       seed=st.integers(0, 2 ** 16))
def test_pil_bilinear_equals_pillow(h, w, oh, ow, seed):
    frames = _frames(np.random.default_rng(seed), 2, h, w)
    want = np.stack([np.asarray(Image.fromarray(f).resize(
        (ow, oh), Image.BILINEAR)) for f in frames])
    got = I.resize_pil_bilinear_u8(frames, ow, oh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        I.resize_pil_bilinear_u8_plain(frames, ow, oh), got)


@settings(max_examples=30, deadline=None, database=None)
@given(h=st.integers(1, 512), w=st.integers(1, 512),
       fx=st.one_of(st.floats(0.05, 2.5), st.sampled_from([0.5, 1.0, 2.0])),
       fy=st.one_of(st.none(), st.floats(0.05, 2.5)),
       seed=st.integers(0, 2 ** 16))
def test_cv2_linear_equals_opencv(h, w, fx, fy, seed):
    fy = fx if fy is None else fy
    if round(h * fy) < 1 or round(w * fx) < 1:
        with pytest.raises(ValueError, match="empty"):
            I.resize_cv2_linear_u8(np.zeros((1, h, w, 3), np.uint8), fx, fy)
        return
    frames = _frames(np.random.default_rng(seed), 2, h, w)
    want = np.stack([cv2.resize(f, (0, 0), fx=fx, fy=fy) for f in frames])
    got = I.resize_cv2_linear_u8(frames, fx, fy)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        I.resize_cv2_linear_u8_plain(frames, fx, fy), got)


@pytest.mark.parametrize("h,w", [(256, 456), (255, 341), (448, 796),
                                 (224, 398)])
def test_transform_geometries_equal_pillow_and_opencv(h, w):
    """EPIC's 256 x 456 frames to 224 both ways, an odd frame, a frame
    twice the crop (cv2's INTER_AREA route) and one already at it."""
    frames = _frames(np.random.default_rng(h), 3, h, w)
    width, height = FX.pil_resize_size(h, w)
    s = FX.cv2_scale(h)
    want_pil = np.stack([np.asarray(Image.fromarray(f).resize(
        (width, height), Image.BILINEAR)) for f in frames])
    want_cv2 = np.stack([cv2.resize(f, (0, 0), fx=s, fy=s) for f in frames])
    for fn, want in ((lambda a: I.resize_pil_bilinear_u8(a, width, height),
                      want_pil),
                     (lambda a: I.resize_pil_bilinear_u8_plain(a, width,
                                                               height),
                      want_pil),
                     (lambda a: I.resize_cv2_linear_u8(a, s, s), want_cv2),
                     (lambda a: I.resize_cv2_linear_u8_plain(a, s, s),
                      want_cv2)):
        np.testing.assert_array_equal(fn(frames), want)
        # a strided view (the omnivore transform passes BGR views)
        np.testing.assert_array_equal(fn(frames[..., ::-1]),
                                      want[..., ::-1])


def test_resizes_refuse_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        I.resize_pil_bilinear_u8(np.zeros((2, 4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError, match="uint8"):
        I.resize_cv2_linear_u8(np.zeros((4, 4, 3), np.uint8), 0.5, 0.5)
    with pytest.raises(ValueError, match="fx"):
        I.resize_cv2_linear_u8(np.zeros((1, 4, 4, 3), np.uint8), 0.0, 1.0)


def _epic_bytes():
    with open(os.path.join(FIXTURE_DIR, FILES[0]), "rb") as f:
        return f.read()


def _segment(data: bytes, marker: int) -> int:
    """Offset of the first segment with ``marker`` before the scan."""
    for m, off, _ in FX.segments(data):
        if m == marker:
            return off
    raise KeyError(hex(marker))


def _drop_segments(data: bytes, marker: int) -> bytes:
    out, p = bytearray(data[:2]), 2
    for m, off, n in FX.segments(data):
        if m != marker:
            out += data[off:off + n]
        p = off + n
    return bytes(out + data[p:])


def _cmyk():
    b = io.BytesIO()
    Image.fromarray(np.full((16, 16, 4), 90, np.uint8), "CMYK").save(b, "JPEG")
    return b.getvalue()


def _refusals():
    data = _epic_bytes()
    sof = _segment(data, 0xC0)

    def with_byte(at, value):
        d = bytearray(data)
        d[at] = value
        return bytes(d)

    return {
        "lossless": (with_byte(sof + 1, 0xC3), r"SOF3 \(lossless"),
        "arithmetic": (with_byte(sof + 1, 0xC9), r"SOF9 \(lossless, hier"),
        "12-bit": (with_byte(sof + 4, 12), r"12-bit samples"),
        "cmyk": (_cmyk(), r"4 components"),
        "no-huffman": (_drop_segments(data, 0xC4), r"no DC Huffman table"),
        "no-quant": (_drop_segments(data, 0xDB), r"no quantisation table"),
        "truncated": (data[:len(data) // 2], r"file truncated inside the scan"),
        "no-eoi": (data[:-2], r"no EOI marker|no marker after the scan"),
        "not-jpeg": (b"GIF89a" + data[6:], r"no SOI"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_refusals_name_the_marker_or_offset(lib, case):
    data, pattern = _refusals()[case]
    with pytest.raises(ValueError, match=pattern) as e:
        J.decode_jpeg(data, apply_orientation=False)
    assert "byte offset" in str(e.value)


def test_flipped_scan_bytes_raise_or_change_the_pixels(lib):
    data = _epic_bytes()
    want = J.decode_jpeg(data, apply_orientation=False)
    start = data.index(b"\xff\xda") + 14
    refused = changed = 0
    for at in range(start, len(data) - 2, 7):
        if data[at] in (0x00, 0xFF):
            continue
        d = bytearray(data)
        d[at] ^= 0xFF
        try:
            got = J.decode_jpeg(bytes(d), apply_orientation=False)
        except ValueError as e:
            assert "byte offset" in str(e)
            refused += 1
        else:
            assert not np.array_equal(got, want), at
            changed += 1
    assert refused > 0 and changed > 0
    # the flip chip_smoke.py's phase 29d makes
    d = bytearray(data)
    d[FX.FLIP_OFFSET] ^= 0xFF
    with pytest.raises(ValueError, match="byte offset"):
        J.decode_jpeg(bytes(d), apply_orientation=False)


def test_read_jpegs_equals_read_jpeg(lib, tmp_path):
    paths = FX.frame_paths()["P01_01"]
    order = [paths[i] for i in (3, 0, 0, 7, 11)]
    clip = J.read_jpegs(order, apply_orientation=False)
    assert clip.shape == (5, 256, 456, 3) and clip.dtype == np.uint8
    for got, path in zip(clip, order):
        np.testing.assert_array_equal(got, J.read_jpeg(
            path, apply_orientation=False))
    for got, path in zip(clip, order):       # one buffer reused across a clip
        with open(path, "rb") as f:
            np.testing.assert_array_equal(got, J.decode_jpeg(
                f.read(), apply_orientation=False))
    missing = str(tmp_path / "frame_0000000099.jpg")
    with pytest.raises(FileNotFoundError, match="frame_0000000099"):
        J.read_jpegs(order + [missing], apply_orientation=False)
    with pytest.raises(FileNotFoundError, match="frame_0000000099"):
        J.read_jpeg(missing, apply_orientation=False)
    other = os.path.join(FIXTURE_DIR, "images", "q5.jpg")
    with pytest.raises(ValueError, match="64x80, expected 256x456"):
        J.read_jpegs(order + [other], apply_orientation=False)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(_epic_bytes()[:3000])
    with pytest.raises(ValueError, match="bad.jpg: JPEG|bad.jpg: file"):
        J.read_jpegs(order[:1] + [str(bad)], apply_orientation=False)


def test_no_compiler_raises(monkeypatch, tmp_path):
    """No g++ and no built library: ``RuntimeError`` naming g++, and no
    other route."""
    monkeypatch.setattr(J, "_lib", None)
    monkeypatch.setattr(J, "_LIB", str(tmp_path / "libtimjpeg.so"))
    monkeypatch.setattr(J.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        J.decode_jpeg(_epic_bytes(), apply_orientation=False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        I.resize_pil_bilinear_u8(np.zeros((1, 4, 4, 3), np.uint8), 2, 2)


def test_exif_orientation_is_read_as_opencv_reads_it(lib):
    """Only the first APP1 counts; a second Exif block does not; an
    orientation outside 1-8 leaves the frame as it is."""
    data = _epic_bytes()
    plain = J.decode_jpeg(data, apply_orientation=False)

    def app1(body):
        return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body

    cases = {
        (6,): plain.transpose(1, 0, 2)[:, ::-1],
        (3, 6): plain[::-1, ::-1],
        (9,): plain,
        (0,): plain,
    }
    for orientations, want in cases.items():
        blocks = b"".join(app1(FX.exif(o, big_endian=o == 3))
                          for o in orientations)
        d = data[:2] + blocks + data[2:]
        np.testing.assert_array_equal(
            J.decode_jpeg(d, apply_orientation=True), want)
        np.testing.assert_array_equal(_cv2(d), want)
        np.testing.assert_array_equal(
            J.decode_jpeg(d, apply_orientation=False), plain)
