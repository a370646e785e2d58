"""JPEG frames without PIL or cv2: the port's own decoder,
``csrc/host/jpeg.cc``, compiled with ``g++`` on first use into
``tim_tpu_torch/build/`` and loaded with ctypes. The same host library
holds the per-pixel loops of ``extract.image`` (``jpeg.cc``'s resizes) and
``extract.imageops`` (``csrc/host/imageops.cc``).

It reproduces libjpeg-turbo's default decompression, which is what both of
the reference's frame readers give: ``np.asarray(Image.open(f).convert(
"RGB"))`` (Pillow) and ``cv2.imread(f, cv2.IMREAD_COLOR)`` turned to RGB
(OpenCV). It reads baseline, extended sequential and progressive Huffman
JPEGs with 8-bit samples, grayscale or three components (YCbCr, or RGB
where an Adobe marker or the component ids say so), any sampling factors
from 1 to 4, restart markers. The two readers differ on the Exif
Orientation: Pillow ignores it, ``imread`` applies it. So every call says
which it wants (``apply_orientation``), and the values 1-8 are applied as
``imread`` applies them.

- ``decode_jpeg(data, *, apply_orientation)``: bytes -> uint8 [H, W, 3] RGB.
- ``read_jpeg(path, *, apply_orientation)``: one file.
- ``read_jpegs(paths, *, apply_orientation)``: a clip's frames, decoded in
  one call into one uint8 [T, H, W, 3] array;
  every frame must have the first one's size.

A file the decoder does not read (lossless, hierarchical or arithmetic
coding, 12-bit samples, CMYK/YCCK, a bad Huffman code, a missing table, a
truncated file, a missing EOI) raises ``ValueError`` naming the file, the
marker or the byte offset; a missing file raises ``FileNotFoundError``. A
host without ``g++`` raises ``RuntimeError``: there is no other route.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = tuple(os.path.join(_PKG, "csrc", "host", name)
              for name in ("jpeg.cc", "imageops.cc"))
_LIB_DIR = os.path.join(_PKG, "build")
_LIB = os.path.join(_LIB_DIR, "libtimjpeg.so")
_ERR = 512

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(
            "the port's JPEG decoder, uint8 resizes and image ops "
            "(csrc/host/jpeg.cc, imageops.cc) are compiled with g++, which "
            "is not on PATH")
    os.makedirs(_LIB_DIR, exist_ok=True)
    # a unique temporary name and an atomic rename: no process loads a
    # half-written library
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    run = subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC",
         "-ffp-contract=off", *_SRCS, "-o", tmp], capture_output=True,
        text=True)
    if run.returncode:
        raise RuntimeError(f"g++ failed to build {_SRCS}:\n{run.stderr}")
    os.replace(tmp, _LIB)


def library() -> ctypes.CDLL:
    """The bound host library (built and loaded once)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or max(
                map(os.path.getmtime, _SRCS)) > os.path.getmtime(_LIB):
            _build()
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        c_int, c_i64 = ctypes.c_int, ctypes.c_int64
        lib.jpeg_header.restype = c_int
        lib.jpeg_header.argtypes = [u8p, c_i64, c_int, ip, ip,
                                    ctypes.c_char_p, c_int]
        lib.jpeg_decode.restype = c_int
        lib.jpeg_decode.argtypes = [u8p, c_i64, c_int, u8p, c_int, c_int,
                                    ctypes.c_char_p, c_int]
        lib.jpeg_decode_files.restype = c_int
        lib.jpeg_decode_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), c_int, c_int, u8p, c_int, c_int,
            ip, ctypes.c_char_p, c_int]
        lib.resize_pil_bilinear_u8.restype = None
        lib.resize_pil_bilinear_u8.argtypes = [u8p, c_int, c_int, c_int, u8p,
                                               c_int, c_int]
        lib.resize_cv2_linear_u8.restype = None
        lib.resize_cv2_linear_u8.argtypes = [
            u8p, c_int, c_int, c_int, u8p, c_int, c_int, ctypes.c_double,
            ctypes.c_double]
        lib.affine_u8.restype = None
        lib.affine_u8.argtypes = [u8p, c_int, c_int, c_int, u8p,
                                  ctypes.POINTER(ctypes.c_double), c_int, u8p]
        lib.smooth_u8.restype = None
        lib.smooth_u8.argtypes = [u8p, c_int, c_int, c_int, u8p]
        _lib = lib
        return lib


def u8_pointer(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _size(data: bytes, apply_orientation: bool, name: str):
    """(height, width) of the decoded image, from the markers before the
    first scan."""
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    if library().jpeg_header(u8_pointer(buf), buf.size,
                             int(apply_orientation), ctypes.byref(h),
                             ctypes.byref(w), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return h.value, w.value


def decode_jpeg(data: bytes, *, apply_orientation: bool) -> np.ndarray:
    """One JPEG's bytes -> uint8 [H, W, 3] RGB (oriented as ``cv2.imread``
    orients it when ``apply_orientation``, else as Pillow leaves it)."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    h, w = _size(data, apply_orientation, "JPEG")
    err = ctypes.create_string_buffer(_ERR)
    out = np.empty((h, w, 3), np.uint8)
    if lib.jpeg_decode(u8_pointer(buf), buf.size, int(apply_orientation),
                       u8_pointer(out), h, w, err, _ERR):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


def read_jpeg(path, *, apply_orientation: bool) -> np.ndarray:
    """One JPEG file -> uint8 [H, W, 3] RGB."""
    return read_jpegs([path], apply_orientation=apply_orientation)[0]


def read_jpegs(paths: Sequence, *, apply_orientation: bool) -> np.ndarray:
    """A clip's JPEG files -> uint8 [T, H, W, 3] RGB in one call, each into
    its slot of one array. Every frame must be the size of the first (after
    the orientation)."""
    lib = library()
    names = [os.fsencode(p) for p in paths]
    if not names:
        raise ValueError("read_jpegs: no paths")
    with open(names[0], "rb") as f:
        h, w = _size(f.read(), apply_orientation, os.fsdecode(names[0]))
    out = np.empty((len(names), h, w, 3), np.uint8)
    array = (ctypes.c_char_p * len(names))(*names)
    failed = ctypes.c_int(-1)
    err = ctypes.create_string_buffer(_ERR)
    rc = lib.jpeg_decode_files(
        array, len(names), int(apply_orientation), u8_pointer(out), h, w,
        ctypes.byref(failed), err, _ERR)
    if rc == 2:
        raise FileNotFoundError(os.fsdecode(names[failed.value]))
    if rc:
        raise ValueError(
            f"{os.fsdecode(names[failed.value])}: {err.value.decode()}")
    return out
