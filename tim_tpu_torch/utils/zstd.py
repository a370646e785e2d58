"""zstd frames (RFC 8878) through the system's ``libzstd.so.1``, bound with
ctypes: the codec of the JAX package's orbax checkpoints (``utils.ocdbt``
wraps its B-tree nodes in zstd, ``utils.orbax`` compresses every zarr
chunk with it).

- ``decompress(src, out=None)`` decodes exactly one frame with
  ``ZSTD_decompressStream``, since tensorstore writes frames without a
  content size. With ``out`` (a writable buffer: a ``bytearray``, a numpy
  array, a contiguous CPU ``torch.Tensor``) the frame must fill it
  exactly, and the bytes land there with no other copy; without it the
  output grows up to ``limit`` bytes and comes back as a ``bytearray``.
- ``compress(src, level=1)`` writes one frame at orbax's level 1 with
  ``ZSTD_compress2``, with the content size and an XXH64 content
  checksum in the frame, so that ``decompress`` rejects a flipped byte
  in a frame this module wrote (tensorstore's own frames carry no
  checksum; a flip there shows only where it breaks the stream).

A frame that is truncated, corrupt, fails its checksum, is followed by
other bytes or does not fit ``out`` raises ``ValueError``. The library is
loaded at the first call; where it is missing the call raises
``RuntimeError`` naming it. There is no other route.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np
import torch

LIBRARY = "libzstd.so.1"
# ZSTD_cParameter values (zstd.h, stable since 1.4.0)
_C_COMPRESSION_LEVEL, _C_CONTENT_SIZE_FLAG, _C_CHECKSUM_FLAG = 100, 200, 201

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """The bound ``libzstd`` (loaded once)."""
    global _lib
    with _lock:
        if _lib is None:
            name = ctypes.util.find_library("zstd") or LIBRARY
            try:
                lib = ctypes.CDLL(name)
            except OSError as e:
                raise RuntimeError(
                    f"{LIBRARY} (the zstd library) could not be loaded "
                    f"({e}); orbax checkpoints need it") from e
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            for fn, res, args in (
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_createCCtx", vp, []),
                    ("ZSTD_freeCCtx", size_t, [vp]),
                    ("ZSTD_CCtx_setParameter", size_t,
                     [vp, ctypes.c_int, ctypes.c_int]),
                    ("ZSTD_compress2", size_t, [vp, vp, size_t, vp, size_t]),
                    ("ZSTD_createDStream", vp, []),
                    ("ZSTD_freeDStream", size_t, [vp]),
                    ("ZSTD_decompressStream", size_t,
                     [vp, ctypes.POINTER(_OutBuffer),
                      ctypes.POINTER(_InBuffer)])):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def _view(buf, writable: bool = False) -> np.ndarray:
    """The bytes of ``buf`` as a uint8 numpy array sharing its memory."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("zstd buffers are contiguous CPU tensors")
        buf = buf.view(-1).view(torch.uint8).numpy()
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("zstd output buffer is read-only")
    return arr


def compress(src, level: int = 1) -> bytearray:
    """One zstd frame of ``src`` (any contiguous buffer) at ``level``,
    with its content size and checksum."""
    lib = library()
    data = _view(src)
    out = bytearray(lib.ZSTD_compressBound(data.nbytes))
    dst = _view(out, writable=True)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx")
    try:
        for param, value in ((_C_COMPRESSION_LEVEL, level),
                             (_C_CONTENT_SIZE_FLAG, 1),
                             (_C_CHECKSUM_FLAG, 1)):
            _check(lib, lib.ZSTD_CCtx_setParameter(cctx, param, value),
                   "parameter")
        n = _check(lib, lib.ZSTD_compress2(
            cctx, dst.ctypes.data, dst.nbytes, data.ctypes.data,
            data.nbytes), "compress")
    finally:
        lib.ZSTD_freeCCtx(cctx)
    del dst
    del out[n:]
    return out


def decompress(src, out=None, *, limit: int = 1 << 31):
    """Decode the one zstd frame that ``src`` holds: into ``out``, which
    it must fill exactly (returned), or into a new ``bytearray`` of at
    most ``limit`` bytes."""
    lib = library()
    data = _view(src)
    dst = None if out is None else _view(out, writable=True)
    grow = dst is None
    if grow:
        dst = np.empty(max(4 * data.nbytes, 1 << 16), np.uint8)
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream")
    spare = np.empty(1, np.uint8)
    inb = _InBuffer(data.ctypes.data, data.nbytes, 0)
    outb = _OutBuffer(dst.ctypes.data, dst.nbytes, 0)
    try:
        while True:
            if outb.pos == outb.size:
                if grow and outb.size < limit:
                    bigger = np.empty(min(2 * dst.nbytes, limit), np.uint8)
                    bigger[:outb.pos] = dst[:outb.pos]
                    dst = bigger
                    outb = _OutBuffer(dst.ctypes.data, dst.nbytes, outb.pos)
                else:
                    # the output is full: the frame must end without
                    # another byte (its checksum may still be unread)
                    probe = _OutBuffer(spare.ctypes.data, 1, 0)
                    left = _check(lib, lib.ZSTD_decompressStream(
                        ds, ctypes.byref(probe), ctypes.byref(inb)),
                        "decompress")
                    if probe.pos:
                        raise ValueError(
                            f"zstd frame holds more than {outb.size} bytes")
                    if left == 0:
                        break
                    if inb.pos == inb.size:
                        raise ValueError("zstd frame is truncated")
                    continue
            before = (inb.pos, outb.pos)
            left = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            if left == 0:
                break
            if inb.pos == inb.size and (inb.pos, outb.pos) == before:
                raise ValueError("zstd frame is truncated")
    finally:
        lib.ZSTD_freeDStream(ds)
    if inb.pos != inb.size:
        raise ValueError(f"{inb.size - inb.pos} bytes follow the zstd frame")
    if not grow:
        if outb.pos != outb.size:
            raise ValueError(f"zstd frame holds {outb.pos} bytes, "
                             f"{outb.size} expected")
        return out
    return bytearray(dst[:outb.pos])
