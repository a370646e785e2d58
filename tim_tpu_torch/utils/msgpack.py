"""Flax's msgpack checkpoint layout, read and written with torch and numpy
only: the port's counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` and of the ``msgpack`` package they call, for the
files that ``tim_tpu/train/checkpoint.py`` writes.

The layout (msgpack with flax's extension types):

- maps, arrays, nil, bool, ints of every width, float32/float64, str and
  bin, as ``msgpack.packb(use_bin_type=True, strict_types=True)`` writes
  them: the shortest int (unsigned when not negative), float64 for a
  Python float, fix/8/16/32 headers chosen by length, dict order kept;
- ext 1, an array: the msgpack array ``[shape, dtype name, C-order
  bytes]``; ``bfloat16``, which numpy cannot name, is a ``torch.bfloat16``
  leaf here, bit for bit;
- ext 2, a Python ``complex``: the msgpack array ``[real, imag]``;
- ext 3, a numpy scalar: ext 1's encoding of its 0-d array;
- an array of more than ``MAX_CHUNK_SIZE`` bytes that is a dict value (or
  the whole tree) is the map ``{"__msgpack_chunked_array__": True,
  "shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}``.

``msgpack_restore`` returns array leaves as CPU ``torch.Tensor`` views of
one buffer (``load`` reads a file into one ``bytearray``), so no leaf is
copied on the way; only a chunked leaf is concatenated. ``msgpack_serialize``
sorts every dict's keys first, as flax's ``tree_map`` copy does, and joins
its pieces (array leaves as views of their tensors) once. A truncated or
malformed buffer, an unknown extension code or dtype name raises
``ValueError`` with the offset.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# numpy dtype name -> torch dtype of an array leaf
DTYPES = {name: getattr(torch, attr) for name, attr in (
    ("bool", "bool"), ("int8", "int8"), ("int16", "int16"),
    ("int32", "int32"), ("int64", "int64"), ("uint8", "uint8"),
    ("uint16", "uint16"), ("uint32", "uint32"), ("uint64", "uint64"),
    ("float16", "float16"), ("bfloat16", "bfloat16"),
    ("float32", "float32"), ("float64", "float64"),
    ("complex64", "complex64"), ("complex128", "complex128"))
    if hasattr(torch, attr)}
NAMES = {dtype: name for name, dtype in DTYPES.items()}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Decoder:
    """One pass over ``buf`` (a ``bytearray``), each node read at an
    offset of one ``memoryview``."""

    def __init__(self, buf: bytearray):
        self.buf = buf
        self.view = memoryview(buf)

    def fail(self, pos: int, what: str):
        raise ValueError(f"msgpack: {what} at offset {pos}")

    def take(self, pos: int, n: int, what: str) -> int:
        """The offset after ``n`` bytes at ``pos``; raises if the buffer
        ends first."""
        end = pos + n
        if end > len(self.buf):
            self.fail(pos, f"truncated {what} ({n} bytes wanted, "
                           f"{len(self.buf) - pos} left)")
        return end

    def unpack(self, fmt: str, pos: int, what: str):
        end = self.take(pos, struct.calcsize(fmt), what)
        return struct.unpack_from(fmt, self.buf, pos)[0], end

    def length(self, code: int, pos: int, sizes: dict, what: str):
        fmt = sizes[code]
        return self.unpack(fmt, pos, f"{what} length")

    def node(self, pos: int, raw: bool = False) -> Tuple[Any, int]:
        """(the object at ``pos``, the offset after it); ``raw``: str as
        bytes (flax's inner array encoding is read so)."""
        start = pos
        pos = self.take(pos, 1, "type byte")
        b = self.buf[start]
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8f:
            return self.mapping(b & 0x0f, pos, raw)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, pos, raw)
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f, pos, raw)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in _BIN:
            n, pos = self.length(b, pos, _BIN, "bin")
            end = self.take(pos, n, "bin")
            return bytes(self.view[pos:end]), end
        if b in _STR:
            n, pos = self.length(b, pos, _STR, "str")
            return self.string(n, pos, raw)
        if b in _EXT:
            n, pos = self.length(b, pos, _EXT, "ext")
            return self.ext(n, pos)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], pos)
        if b in _SCALAR:
            return self.unpack(_SCALAR[b], pos, "number")
        if b in _ARRAY:
            n, pos = self.length(b, pos, _ARRAY, "array")
            return self.array(n, pos, raw)
        if b in _MAP:
            n, pos = self.length(b, pos, _MAP, "map")
            return self.mapping(n, pos, raw)
        self.fail(start, f"invalid type byte 0x{b:02x}")

    def string(self, n: int, pos: int, raw: bool):
        end = self.take(pos, n, "str")
        data = bytes(self.view[pos:end])
        if raw:
            return data, end
        try:
            return data.decode("utf-8"), end
        except UnicodeDecodeError as e:
            self.fail(pos, f"invalid UTF-8 in a str ({e.reason})")

    def array(self, n: int, pos: int, raw: bool):
        out = []
        for _ in range(n):
            item, pos = self.node(pos, raw)
            out.append(item)
        return out, pos

    def mapping(self, n: int, pos: int, raw: bool):
        out = {}
        for _ in range(n):
            at = pos
            key, pos = self.node(pos, raw)
            if not isinstance(key, (str, bytes)):
                self.fail(at, f"map key of type {type(key).__name__}")
            out[key], pos = self.node(pos, raw)
        return out, pos

    def ext(self, n: int, pos: int):
        start = pos
        pos = self.take(pos, 1, "ext code")
        code = struct.unpack_from("b", self.buf, start)[0]
        end = self.take(pos, n, "ext data")
        if code == EXT_NDARRAY:
            return self.ndarray(pos, end), end
        if code == EXT_NPSCALAR:
            return self.npscalar(pos, end), end
        if code == EXT_COMPLEX:
            parts, stop = self.node(pos)
            if (stop != end or not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(x, (int, float)) for x in parts)):
                self.fail(pos, "malformed complex extension")
            return complex(parts[0], parts[1]), end
        self.fail(start, f"unknown extension code {code}")

    def array_parts(self, pos: int, end: int):
        """(shape, dtype name, data offset, data length) of an ext 1
        payload ``[shape, name, bytes]`` spanning ``pos:end``."""
        start, n = pos, None
        if pos < end and self.buf[pos] == 0x93:
            n, pos = 3, pos + 1
        elif pos < end and self.buf[pos] in _ARRAY:
            n, pos = self.length(self.buf[pos], pos + 1, _ARRAY, "array")
        if n != 3:
            self.fail(start, "an array extension is not a 3-element array")
        shape, pos = self.node(pos)
        name, pos = self.node(pos, raw=True)
        if (not isinstance(shape, list)
                or not all(type(d) is int and d >= 0 for d in shape)
                or not isinstance(name, bytes)):
            self.fail(start, "malformed array extension header")
        if pos >= end or self.buf[pos] not in _BIN:
            self.fail(pos, "array extension without its bin data")
        size, data = self.length(self.buf[pos], pos + 1, _BIN, "bin")
        if data + size != end:
            self.fail(pos, "array extension data does not end the payload")
        return shape, name.decode("ascii", "replace"), data, size

    def ndarray(self, pos: int, end: int) -> torch.Tensor:
        shape, name, data, n = self.array_parts(pos, end)
        if name not in DTYPES:
            self.fail(pos, f"unknown dtype name {name!r}")
        dtype = DTYPES[name]
        count = int(np.prod(shape, dtype=np.int64))
        if count * dtype.itemsize != n:
            self.fail(data, f"{n} data bytes for {name} {tuple(shape)}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self.buf, dtype=dtype, count=count,
                                offset=data).view(shape)

    def npscalar(self, pos: int, end: int):
        shape, name, data, n = self.array_parts(pos, end)
        if name == "bfloat16":
            self.fail(pos, "a bfloat16 numpy scalar (numpy has no bfloat16 "
                           "type)")
        try:
            dtype = np.dtype(name)
        except TypeError:
            self.fail(pos, f"unknown dtype name {name!r}")
        if shape != [] or n != dtype.itemsize or dtype.hasobject:
            self.fail(data, f"malformed {name} numpy scalar")
        return np.frombuffer(self.view[data:data + n], dtype=dtype)[0]


_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SCALAR = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
           0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def unpackb(buf) -> Any:
    """The one msgpack object in ``buf`` (a ``bytearray`` is used in
    place: array leaves are views of it; other buffers are copied once
    into one)."""
    if not isinstance(buf, bytearray):
        buf = bytearray(buf)
    dec = _Decoder(buf)
    obj, end = dec.node(0)
    if end != len(buf):
        dec.fail(end, f"{len(buf) - end} bytes after the object")
    return obj


def _unchunk(d: dict) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_in_place(tree):
    """flax's ``_unchunk_array_leaves_in_place``: through dicts only."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_in_place(v)
    return tree


def msgpack_restore(buf) -> Any:
    """The tree of a flax msgpack buffer (``flax.serialization.
    msgpack_restore``): dicts, lists, Python scalars, ``complex``, numpy
    scalars and CPU tensor leaves."""
    return _unchunk_in_place(unpackb(buf))


def load(path: str) -> Any:
    """``msgpack_restore`` of the file at ``path``, read once into one
    buffer that the array leaves share."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        f.seek(0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"msgpack: {path} changed while it was read")
    return msgpack_restore(buf)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
            what: str) -> bytes:
    """The header of a length-``n`` str/array/map/bin: the fix form below
    ``fix_max`` (when the type has one), else the 8/16/32-bit form."""
    if fix_max and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a {what} of {n} elements is too long")


def _int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    if x >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32),
                                 (0xcf, ">Q", 1 << 64)):
            if x < limit:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31),
                                 (0xd3, ">q", 1 << 63)):
            if x >= -limit:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"msgpack: integer {x} out of range")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _header(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), "str") + data


def _bin_header(n: int) -> bytes:
    return _header(n, 0, 0, (0xc4, 0xc5, 0xc6), "bin")


_FIX_BY_SIZE = {n: code for code, n in _FIXEXT.items()}


def _ext(code: int, payload: List) -> List:
    """An extension: fixext for a payload of 1, 2, 4, 8 or 16 bytes, else
    ext 8/16/32."""
    n = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in payload)
    head = (bytes((_FIX_BY_SIZE[n],)) if n in _FIX_BY_SIZE
            else _header(n, 0, 0, (0xc7, 0xc8, 0xc9), "ext"))
    return [head, struct.pack("b", code), *payload]


def _array_bytes(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, numpy dtype name, C-order bytes as a view) of a tensor or
    numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in NAMES:
            raise ValueError(f"msgpack: no numpy name for {t.dtype}")
        flat = t.reshape(-1).view(torch.uint8) if t.numel() else \
            torch.empty(0, dtype=torch.uint8)
        return tuple(t.shape), NAMES[t.dtype], memoryview(flat.numpy())
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "serialised")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _ndarray_payload(x) -> List:
    shape, name, data = _array_bytes(x)
    head = [bytes((0x93,)), _header(len(shape), 0x90, 16, (None, 0xdc, 0xdd),
                                    "array")]
    head += [_int(d) for d in shape]
    head += [_str(name), _bin_header(data.nbytes)]
    return [b"".join(head), data]


def _pack(obj, out: List) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        out.append(_str(obj))
    elif t in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast("B")
        out += [_bin_header(data.nbytes), data]
    elif t is dict:
        out.append(_header(len(obj), 0x80, 16, (None, 0xde, 0xdf), "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        out.append(_header(len(obj), 0x90, 16, (None, 0xdc, 0xdd), "array"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        out += _ext(EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        out += _ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, complex):
        parts = [b"\x92", b"\xcb" + struct.pack(">d", obj.real),
                 b"\xcb" + struct.pack(">d", obj.imag)]
        out += _ext(EXT_COMPLEX, [b"".join(parts)])
    else:
        raise TypeError(f"msgpack: cannot serialise a "
                        f"{type(obj).__name__} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True, strict_types=True)`` with
    flax's extension hook: a tuple, or a subclass of a Python scalar type
    other than a numpy scalar, raises ``TypeError``."""
    out: List = []
    _pack(obj, out)
    return b"".join(out)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else \
        x.dtype.itemsize


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in pieces of ``MAX_CHUNK_SIZE``
    bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(x)))
    flat = x.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _sorted(tree):
    """A copy of ``tree`` whose dicts have their keys sorted (what the
    ``jax.tree_util.tree_map`` copy in flax's ``msgpack_serialize`` does;
    lists and leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _chunk_in_place(tree):
    """flax's ``_chunk_array_leaves_in_place``: array leaves over
    ``MAX_CHUNK_SIZE`` bytes that are dict values (through dicts only) or
    the whole tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                tree[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_in_place(v)
    elif _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """The bytes that ``flax.serialization.msgpack_serialize`` writes for
    ``tree`` (dicts, lists, Python scalars, ``complex``, numpy scalars,
    numpy arrays and tensors)."""
    return packb(_chunk_in_place(_sorted(tree)))
