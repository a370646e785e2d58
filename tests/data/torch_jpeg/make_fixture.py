"""JPEG files as Pillow and OpenCV write them, for the port's JPEG decoder
(``tim_tpu_torch.utils.jpeg``), its uint8 resizes
(``tim_tpu_torch.extract.image``) and the JPEG routes of visual extraction
and the finetune reader.

Rewrite the fixture from the repository's root (needs PIL, cv2, pandas and
``tim_tpu.extract.tables``)::

    JAX_PLATFORMS=cpu python tests/data/torch_jpeg/make_fixture.py

The files, next to this script, all of seeded smooth synthetic content:

- ``frames/<video>/frame_0000000001.jpg`` ...: two EPIC-sized frame
  directories (456 x 256, 4:2:0, quality 85, as ffmpeg writes EPIC's
  frames), named as the reference names them, and
  ``feature_times.pkl``: ``build_feature_time_table`` of the two videos at
  5 fps, in pandas 1.x's layout (the port reads it without pandas);
- ``images/*.jpg``: the kinds the decoder reads (``IMAGES`` below):
  subsampling 4:4:4, 4:2:2, 4:4:0 and 4:1:1, grayscale, odd sizes
  (455 x 255, 17 x 9, 1 x 1), qualities 100 and 5, optimised Huffman
  tables, restart markers by rows and by blocks (progressive too),
  progressive with and without subsampling, RGB samples marked by
  component ids and by an Adobe marker, and Exif Orientation 1-8 (little
  and big endian).

Each ``.jpg`` has an ``.npz`` twin (``write_twin``): Pillow's decode
(``Image.open(f).convert("RGB")``, the orientation ignored), cv2's
(``imread`` + BGR2RGB, the orientation applied), and the two resizes of
Pillow's decode at the transforms' own sizes: Pillow's BILINEAR to a short
side of ``CROP`` (``preprocess_video_clip``) and ``cv2.resize`` at ``fx =
fy = CROP / H`` (``omnivore_test_transform``). The twin holds no pixels:
for each of those four arrays it keeps the shape and the SHA-256 digest of
the uint8 bytes, since the arrays themselves come to about 42 MB
uncompressed. ``read_twin`` reads them with numpy alone, so a machine
without PIL or cv2 holds the port to them bit for bit (``digest``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import os
import shutil
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CROP = 224
FPS = 5.0
# EPIC frame directories: video id -> frames (2.4 s and 2 s at 5 fps)
VIDEOS = {"P01_01": 12, "P02_03": 10}
FRAME_SIZE = (256, 456)
TWIN_KEYS = ("pil", "cv2", "pil_resize", "cv2_resize")
# A byte inside the first EPIC frame's scan whose flip (XOR 0xFF) the
# decoder refuses: the Huffman codes after it run past the scan's end. It
# was found by trying the bytes from the scan's middle on; JPEG has no
# checksum, so most single-byte flips decode to other pixels instead.
FLIP_OFFSET = 5302

# name -> (height, width, writer, options)
IMAGES = {
    "s444.jpg": (256, 456, "pil", dict(quality=90, subsampling=0)),
    "s422.jpg": (72, 120, "pil", dict(quality=90, subsampling=1)),
    "s440.jpg": (72, 120, "cv2", dict(quality=90, sampling=0x121111)),
    "s411.jpg": (72, 120, "cv2", dict(quality=90, sampling=0x411111)),
    "gray.jpg": (60, 100, "pil", dict(quality=85, gray=True)),
    "odd_455x255.jpg": (255, 455, "pil", dict(quality=85, subsampling=2)),
    "odd_17x9.jpg": (9, 17, "pil", dict(quality=90, subsampling=2)),
    "one_1x1.jpg": (1, 1, "pil", dict(quality=90, subsampling=2)),
    "q100.jpg": (64, 80, "pil", dict(quality=100, subsampling=2,
                                        noise=24.0)),
    "q5.jpg": (64, 80, "pil", dict(quality=5, subsampling=2)),
    "optimized.jpg": (72, 88, "pil", dict(quality=80, optimize=True)),
    "restart_rows.jpg": (72, 88, "pil", dict(quality=85,
                                               restart_marker_rows=1)),
    "restart_blocks.jpg": (72, 88, "pil", dict(quality=85,
                                                 restart_marker_blocks=5)),
    "progressive_420.jpg": (256, 456, "pil", dict(quality=85,
                                                  progressive=True)),
    "progressive_444.jpg": (72, 88, "pil", dict(quality=90, subsampling=0,
                                                  progressive=True)),
    "progressive_restart.jpg": (72, 88, "cv2", dict(
        quality=90, sampling=0x221111, progressive=True, restart=3)),
    "rgb_ids.jpg": (48, 64, "pil", dict(quality=90, rgb="ids")),
    "rgb_adobe.jpg": (48, 64, "pil", dict(quality=90, rgb="adobe")),
    **{f"exif_{o}.jpg": (24, 40, "pil", dict(quality=90, orientation=o,
                                             big_endian=o % 2 == 0))
       for o in range(1, 9)},
}


def frame_paths() -> dict:
    """video id -> its frame files, in order."""
    return {vid: [os.path.join(HERE, "frames", vid,
                               f"frame_{i:010d}.jpg")
                  for i in range(1, n + 1)] for vid, n in VIDEOS.items()}


def jpeg_files() -> list:
    """Every ``.jpg`` of the fixture: the frames, then ``images/``."""
    return ([p for ps in frame_paths().values() for p in ps]
            + [os.path.join(HERE, "images", n) for n in IMAGES])


def twin_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".npz"


def pil_resize_size(h: int, w: int):
    """(width, height) of ``preprocess_video_clip``'s resize."""
    scale = CROP / min(h, w)
    return int(round(w * scale)), int(round(h * scale))


def cv2_scale(h: int) -> float:
    """``omnivore_test_transform``'s fx = fy."""
    return CROP / h


def digest(array: np.ndarray) -> tuple:
    """(shape, SHA-256 hex digest of the C-order bytes) of a uint8 array."""
    array = np.ascontiguousarray(array, np.uint8)
    return tuple(array.shape), hashlib.sha256(array.tobytes()).hexdigest()


def read_twin(path: str) -> dict:
    """A ``.jpg``'s twin -> {"pil", "cv2", "pil_resize", "cv2_resize"}:
    (shape, SHA-256 hex digest) of each uint8 [H, W, 3] array (numpy
    alone); ``digest(a) == twin[key]`` holds ``a`` to it bit for bit."""
    with np.load(twin_path(path), allow_pickle=False) as z:
        return {k: (tuple(int(v) for v in z[k + "_shape"]),
                    z[k + "_sha256"].tobytes().hex()) for k in TWIN_KEYS}


def write_twin(path: str, arrays: dict) -> None:
    out = {}
    for k in TWIN_KEYS:
        shape, hexdigest = digest(arrays[k])
        out[k + "_shape"] = np.asarray(shape, np.int64)
        out[k + "_sha256"] = np.frombuffer(bytes.fromhex(hexdigest), np.uint8)
    np.savez(twin_path(path), **out)


def content(h: int, w: int, rng, noise: float = 0.0) -> np.ndarray:
    """Smooth waves in each channel, a few flat boxes, and ``noise``."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(3):
            img[..., c] += rng.uniform(15, 45) * np.sin(
                rng.uniform(0.005, 0.06) * x + rng.uniform(0.005, 0.06) * y
                + rng.uniform(0, 6.3))
    for _ in range(3):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 4 + 1, x0:x0 + w // 5 + 1] = rng.uniform(20, 235, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def segments(data: bytes) -> list:
    """(marker, offset, length) of the segments before the first SOS."""
    out, p = [], 2
    while data[p + 1] != 0xDA:
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((data[p + 1], p, n + 2))
        p += n + 2
    return out


def mark_rgb(data: bytes, how: str) -> bytes:
    """A YCbCr-less JPEG (samples stored as written) marked as RGB: without
    its JFIF APP0, and with component ids 'R', 'G', 'B' ("ids") or an
    Adobe APP14 whose transform is 0 ("adobe")."""
    out = bytearray(data[:2])
    rest = 2
    for marker, off, n in segments(data):
        seg = bytearray(data[off:off + n])
        if marker == 0xE0:
            rest = off + n
            continue
        if marker in (0xC0, 0xC1, 0xC2) and how == "ids":
            for i, cid in enumerate(b"RGB"):
                seg[10 + 3 * i] = cid
        out += seg
        rest = off + n
    if how == "adobe":
        adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
        out[2:2] = b"\xff\xee" + struct.pack(">H", len(adobe) + 2) + adobe
    if how == "ids":
        # the SOS names components by id too
        sos = bytearray(data[rest:])
        for i, cid in enumerate(b"RGB"):
            sos[5 + 2 * i] = cid
        return bytes(out + sos)
    return bytes(out + data[rest:])


def exif(orientation: int, big_endian: bool) -> bytes:
    """An Exif block (after PIL's "Exif\\0\\0"): IFD0 holding Orientation."""
    e = ">" if big_endian else "<"
    return (b"Exif\x00\x00" + (b"MM" if big_endian else b"II")
            + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHIHH", 0x010F, 2, 4, 0x6F6F, 0)   # Make "oo"
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


def encode(img: np.ndarray, writer: str, opts: dict) -> bytes:
    from PIL import Image
    opts = dict(opts)
    opts.pop("noise", None)
    if writer == "cv2":
        import cv2
        params = [cv2.IMWRITE_JPEG_QUALITY, opts["quality"],
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, opts["sampling"]]
        if opts.get("progressive"):
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if opts.get("restart"):
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, opts["restart"]]
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
        assert ok
        return enc.tobytes()
    im = Image.fromarray(img)
    if opts.pop("gray", False):
        im = im.convert("L")
    rgb = opts.pop("rgb", None)
    if rgb:
        # the RGB samples written as they are (no colour transform)
        im = Image.frombytes("YCbCr", im.size, img.tobytes())
        opts["subsampling"] = 0
    orientation = opts.pop("orientation", None)
    big_endian = opts.pop("big_endian", False)
    if orientation:
        opts["exif"] = exif(orientation, big_endian)
    b = io.BytesIO()
    im.save(b, "JPEG", **opts)
    data = b.getvalue()
    return mark_rgb(data, rgb) if rgb else data


def decode_all(path: str) -> dict:
    import cv2
    from PIL import Image
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    cv = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    w, h = pil_resize_size(*pil.shape[:2])
    s = cv2_scale(pil.shape[0])
    return {"pil": pil, "cv2": np.ascontiguousarray(cv),
            "pil_resize": np.asarray(Image.fromarray(pil).resize(
                (w, h), Image.BILINEAR)),
            "cv2_resize": cv2.resize(pil, (0, 0), fx=s, fy=s)}


def tables_fixture():
    spec = importlib.util.spec_from_file_location(
        "torch_tables_fixture",
        os.path.join(os.path.dirname(HERE), "torch_tables", "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    from tim_tpu.extract.tables import build_feature_time_table
    from tim_tpu_torch.data.table import Table

    rng = np.random.default_rng(19)
    for sub in ("frames", "images"):
        shutil.rmtree(os.path.join(HERE, sub), ignore_errors=True)
    for vid, paths in frame_paths().items():
        os.makedirs(os.path.dirname(paths[0]))
        base = content(*FRAME_SIZE, rng, noise=1.0)
        for i, path in enumerate(paths):
            # a slow pan: each frame the base shifted a few pixels
            frame = np.roll(base, 3 * i, axis=1)
            with open(path, "wb") as f:
                f.write(encode(frame, "pil", dict(quality=85,
                                                  subsampling=2)))
    os.makedirs(os.path.join(HERE, "images"))
    for name, (h, w, writer, opts) in IMAGES.items():
        img = content(h, w, rng, opts.get("noise", 0.0))
        with open(os.path.join(HERE, "images", name), "wb") as f:
            f.write(encode(img, writer, opts))
    for path in jpeg_files():
        arrays = decode_all(path)
        write_twin(path, arrays)
        back = read_twin(path)
        assert all(back[k] == digest(arrays[k]) for k in TWIN_KEYS)

    tables = tables_fixture()
    durations = {vid: n / FPS for vid, n in VIDEOS.items()}
    table = Table.from_frame(build_feature_time_table(durations, fps=FPS))
    path = os.path.join(HERE, "feature_times.pkl")
    tables.write_pandas1_pickle(table, path)
    import pandas as pd
    assert Table.from_frame(pd.read_pickle(path)).equals(table)
    tables.write_twin(table, twin_path(path))
    assert tables.read_twin(twin_path(path)).equals(table)

    sizes, total = {}, 0
    for dirpath, _, files in os.walk(HERE):
        for n in sorted(files):
            if n.endswith(".py"):
                continue
            with open(os.path.join(dirpath, n), "rb") as f:
                data = f.read()
            rel = os.path.relpath(os.path.join(dirpath, n), HERE)
            sizes[rel] = [len(data), hashlib.sha256(data).hexdigest()[:12]]
            total += len(data)
    print(json.dumps(sizes, sort_keys=True), total, "bytes;",
          len(table), "feature rows")


if __name__ == "__main__":
    main()
