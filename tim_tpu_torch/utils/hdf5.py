"""HDF5 files read with ``struct``, ``zlib`` and numpy only (no h5py).

The subset of h5py's read API that the extraction CLI uses::

    with File(path_or_fileobj) as f:
        wave = np.asarray(f["P01_01"], np.float32)

``File`` is the root ``Group`` and a context manager; ``f[name]``
follows ``/``-separated paths and soft links; a ``Group`` has ``keys()``
(h5py's order: by creation order where the group tracks it, else by
name), ``__contains__`` and ``__getitem__``; a ``Dataset`` has ``shape``,
``dtype``, ``read()`` and ``__array__``.

What is read (names as in the HDF5 file format specification, version 3),
which is everything h5py 3.x writes for numeric datasets under
``libver="earliest"`` and ``libver="latest"``:

- superblock versions 0 and 1, and 2 and 3 (checksummed), searched for at
  offsets 0, 512, 1024, 2048, ... (a user block before it), addresses
  taken from its base address;
- object headers version 1 (messages 8-byte aligned) and version 2
  (``OHDR``, ``OCHK`` continuation blocks, optional times), both with
  continuation messages; attributes, times, comments, reference counts,
  attribute info and B-tree K values are skipped;
- old-style groups (symbol-table message, version 1 group B-tree
  ``TREE``, ``SNOD`` symbol nodes, the local heap ``HEAP``) and new-style
  ones (link-info and link messages; dense links in a fractal heap
  ``FRHP``/``FHDB``/``FHIB`` indexed by a version 2 B-tree
  ``BTHD``/``BTIN``/``BTLF`` of record type 5); hard and soft links;
- fixed-point and IEEE floating-point data of 1, 2, 4 and 8 bytes in
  either byte order; dataspace messages 1 and 2 (scalar and null too);
  the old and new fill-value messages;
- layout message 3 (compact, contiguous, chunked through a version 1
  B-tree of type 1) and 4 (compact, contiguous, and chunks indexed by a
  single chunk, implicitly, by a fixed array ``FAHD``/``FADB`` (paged
  past 2**page_bits entries), an extensible array
  ``EAHD``/``EAIB``/``EASB``/``EADB`` or a version 2 B-tree of record
  types 10 and 11); edge chunks cut to the extent;
- filter pipelines 1 and 2: deflate, shuffle, fletcher32 (verified) and
  LZF (h5py's filter 32000); a chunk's filter mask is honoured.

Every checksummed structure's Jenkins lookup3 is verified. Refused, with
an error naming the feature and the object: other datatype classes
(compound, string, ...), other filters (SZIP, N-bit, scale-offset,
third-party ids), external storage, virtual datasets, external links,
shared messages and superblock extensions holding a shared-message table
or multi-file layout information. A checksum mismatch, a truncated file
or a file that is not HDF5 raises ``OSError`` or ``ValueError`` naming
the path and the structure; a missing name raises ``KeyError`` naming it
and the file.

A dataset is read into one preallocated array: contiguous data with one
``readinto`` at its offset, chunks one by one. Only the metadata on the
way to an object and that object's data are read, never the whole file.
"""

from __future__ import annotations

import io
import itertools
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
MASK32 = 0xFFFFFFFF
UNLIMITED = 2 ** 64 - 1

# message types of an object header
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_EXTERNAL = 0x4, 0x5, 0x6, 0x7
MSG_LAYOUT, MSG_GROUP_INFO, MSG_FILTERS = 0x8, 0xA, 0xB
MSG_SHARED_TABLE, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xF, 0x10, 0x11
MSG_FILE_LAYOUT = 0x14

DATATYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time",
                    3: "string", 4: "bitfield", 5: "opaque",
                    6: "compound", 7: "reference", 8: "enum",
                    9: "variable-length", 10: "array"}
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
                32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                32015: "zstd"}
# exponent location, exponent size, mantissa size, bias of IEEE floats
IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


# ---------------------------------------------------------------------------
# checksums and filters
# ---------------------------------------------------------------------------

def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & MASK32


def lookup3(data) -> int:
    """Bob Jenkins's lookup3 ``hashlittle`` of ``data`` with initval 0,
    HDF5's metadata checksum (``H5_checksum_lookup3``)."""
    data = bytes(data)
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & MASK32
    if n == 0:
        return c
    tail = n - ((n - 1) % 12 + 1)           # bytes before the last block
    words = struct.unpack_from(f"<{tail // 4}I", data)
    for i in range(0, len(words), 3):
        a = (a + words[i]) & MASK32
        b = (b + words[i + 1]) & MASK32
        c = (c + words[i + 2]) & MASK32
        a = ((a - c) & MASK32) ^ _rot(c, 4)
        c = (c + b) & MASK32
        b = ((b - a) & MASK32) ^ _rot(a, 6)
        a = (a + c) & MASK32
        c = ((c - b) & MASK32) ^ _rot(b, 8)
        b = (b + a) & MASK32
        a = ((a - c) & MASK32) ^ _rot(c, 16)
        c = (c + b) & MASK32
        b = ((b - a) & MASK32) ^ _rot(a, 19)
        a = (a + c) & MASK32
        c = ((c - b) & MASK32) ^ _rot(b, 4)
        b = (b + a) & MASK32
    last = struct.unpack("<3I", data[tail:].ljust(12, b"\0"))
    a = (a + last[0]) & MASK32
    b = (b + last[1]) & MASK32
    c = (c + last[2]) & MASK32
    c ^= b
    c = (c - _rot(b, 14)) & MASK32
    a ^= c
    a = (a - _rot(c, 11)) & MASK32
    b ^= a
    b = (b - _rot(a, 25)) & MASK32
    c ^= b
    c = (c - _rot(b, 16)) & MASK32
    a ^= c
    a = (a - _rot(c, 4)) & MASK32
    b ^= a
    b = (b - _rot(a, 14)) & MASK32
    c ^= b
    c = (c - _rot(b, 24)) & MASK32
    return c


def fletcher32(data) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): sums of big-endian
    16-bit words (an odd last byte is the high byte of a last word) with
    end-around carries, so a sum that is a non-zero multiple of 65535
    reads 65535."""
    buf = np.frombuffer(data, np.uint8)
    if len(buf) % 2:
        buf = np.concatenate([buf, np.zeros(1, np.uint8)])
    words = buf.view(">u2").astype(np.int64)
    n = len(words)
    s1 = s2 = 0
    for lo in range(0, n, 1 << 20):
        w = words[lo:lo + (1 << 20)]
        weights = (n - lo - np.arange(len(w), dtype=np.int64)) % 65535
        s1 = (s1 + int(w.sum())) % 65535
        s2 = (s2 + int((w * weights).sum() % 65535)) % 65535
    if not words.any():
        return 0
    fold = [v if v else 65535 for v in (s1, s2)]
    return (fold[1] << 16) | fold[0]


def lzf_decompress(data, size: int) -> bytes:
    """LZF (h5py's filter 32000): control byte ``c < 32`` copies ``c + 1``
    literal bytes; otherwise a back reference of ``(c >> 5) + 2`` bytes
    (``+ next byte`` when ``c >> 5`` is 7) ending ``((c & 31) << 8) +
    next byte + 1`` bytes back."""
    src = bytes(data)
    out = bytearray(size)
    ip = op = 0
    n = len(src)
    while ip < n:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:
            length = ctrl + 1
            if op + length > size or ip + length > n:
                raise ValueError("LZF literal run past the chunk")
            out[op:op + length] = src[ip:ip + length]
            ip += length
            op += length
            continue
        length = ctrl >> 5
        if length == 7:
            length += src[ip]
            ip += 1
        ref = op - ((ctrl & 0x1F) << 8) - src[ip] - 1
        ip += 1
        length += 2
        if ref < 0 or op + length > size:
            raise ValueError("LZF back reference outside the chunk")
        if op - ref >= length:
            out[op:op + length] = out[ref:ref + length]
        else:                               # overlapping: a repeated run
            period = bytes(out[ref:op])
            out[op:op + length] = (period * (length // len(period) + 1)
                                   )[:length]
        op += length
    if op != size:
        raise ValueError(f"LZF gave {op} bytes, expected {size}")
    return bytes(out)


def unshuffle(data, itemsize: int) -> bytes:
    """Undo the shuffle filter: byte ``k`` of every element is stored
    together; bytes past the last whole element are left in place."""
    buf = np.frombuffer(data, np.uint8)
    n = len(buf) // itemsize
    if itemsize <= 1 or n <= 1:
        return bytes(buf)
    body = buf[:n * itemsize].reshape(itemsize, n).T.tobytes()
    return body + bytes(buf[n * itemsize:])


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

class _Buf:
    """A cursor over one structure's bytes."""

    def __init__(self, f: "_File", data, addr: int, what: str):
        self.f, self.data, self.addr, self.what = f, data, addr, what
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.f.error(f"{self.what} at {self.addr} ends early",
                               OSError)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self) -> int:
        return self.uint(1)

    def u16(self) -> int:
        return self.uint(2)

    def u32(self) -> int:
        return self.uint(4)

    def addr_(self):
        """An address, ``None`` where undefined (all bits set)."""
        raw = self.take(self.f.sizeof_addr)
        return None if raw == b"\xff" * len(raw) else int.from_bytes(
            raw, "little")

    def length(self) -> int:
        return self.uint(self.f.sizeof_size)

    def skip(self, n: int) -> None:
        self.take(n)


class _File:
    """The open file, its superblock's sizes and the reads below objects."""

    def __init__(self, fileobj, name: str, owned: bool):
        self.fh, self.name, self.owned = fileobj, name, owned
        self.fh.seek(0, io.SEEK_END)
        self.size = self.fh.tell()
        self.sizeof_addr = self.sizeof_size = 8
        self.base = 0
        self.heaps = {}
        self._superblock()

    # -- raw reads ----------------------------------------------------------

    def error(self, msg: str, kind=ValueError):
        return kind(f"{self.name}: {msg}")

    def read(self, addr: int, n: int, what: str) -> bytes:
        """``n`` bytes at file address ``addr`` (relative to the base)."""
        pos = self.base + addr
        if addr < 0 or pos + n > self.size:
            raise self.error(f"truncated: {what} at {addr} needs bytes "
                             f"{pos}-{pos + n} of {self.size}", OSError)
        self.fh.seek(pos)
        out = self.fh.read(n)
        if len(out) != n:
            raise self.error(f"truncated: {what} at {addr}", OSError)
        return out

    def readinto(self, addr: int, view: memoryview, what: str) -> None:
        n = view.nbytes
        pos = self.base + addr
        if addr < 0 or pos + n > self.size:
            raise self.error(f"truncated: {what} at {addr} needs bytes "
                             f"{pos}-{pos + n} of {self.size}", OSError)
        self.fh.seek(pos)
        got = 0
        while got < n:
            k = self.fh.readinto(view[got:])
            if not k:
                raise self.error(f"truncated: {what} at {addr}", OSError)
            got += k

    def buf(self, addr: int, n: int, what: str) -> _Buf:
        return _Buf(self, self.read(addr, n, what), addr, what)

    def checked(self, addr: int, n: int, what: str, sig: bytes) -> _Buf:
        """A checksummed structure of ``n`` bytes (the last 4 its lookup3):
        its signature and checksum verified; the cursor after the
        signature."""
        data = self.read(addr, n, what)
        if data[:4] != sig:
            raise self.error(f"{what} at {addr}: signature {data[:4]!r}, "
                             f"expected {sig!r}")
        want = struct.unpack_from("<I", data, n - 4)[0]
        if lookup3(data[:n - 4]) != want:
            raise self.error(f"{what} at {addr}: checksum mismatch")
        out = _Buf(self, data[:n - 4], addr, what)
        out.pos = 4
        return out

    # -- superblock ---------------------------------------------------------

    def _superblock(self) -> None:
        pos = 0
        while True:
            if pos + 8 > self.size:
                raise self.error("not an HDF5 file (no superblock signature "
                                 "at 0, 512, 1024, 2048, ...)", OSError)
            self.fh.seek(pos)
            if self.fh.read(8) == SIGNATURE:
                break
            pos = 512 if pos == 0 else pos * 2
        self.fh.seek(pos)
        head = self.fh.read(min(256, self.size - pos))
        version = head[8]
        what = f"superblock version {version}"
        b = _Buf(self, head, pos, what)
        b.skip(9)
        if version in (0, 1):
            b.skip(4)           # free-space, root entry, -, shared versions
            self.sizeof_addr, self.sizeof_size = b.u8(), b.u8()
            b.skip(9)           # -, group K values, consistency flags
            if version == 1:
                b.skip(4)       # indexed-storage K, reserved
            b.addr_()           # base address (the signature's offset)
            b.addr_()           # free-space info
            eof = b.addr_()
            if b.addr_() is not None:
                raise self.error(f"{what}: a multi-file layout (its "
                                 "information block) is not supported")
            b.skip(self.sizeof_addr)        # root entry: link name offset
            root = b.addr_()
        elif version in (2, 3):
            self.sizeof_addr, self.sizeof_size = b.u8(), b.u8()
            b.skip(1)
            b.addr_()           # base address (the signature's offset)
            ext = b.addr_()
            eof = b.addr_()
            root = b.addr_()
            want = b.u32()
            if lookup3(head[:b.pos - 4]) != want:
                raise self.error(f"{what} at {pos}: checksum mismatch")
        else:
            raise self.error(f"{what} is not supported")
        self.base = pos         # as HDF5 does when the two differ
        # HDF5 compares the end-of-file address with the file's size (a
        # user block included)
        if eof is not None and self.size < eof:
            raise self.error(
                f"truncated: the superblock's end-of-file address is {eof}, "
                f"the file has {self.size} bytes", OSError)
        if version >= 2 and ext is not None:
            for mtype, _, _ in self.header(ext, "superblock extension"):
                if mtype in (MSG_SHARED_TABLE, MSG_FILE_LAYOUT):
                    name = ("a shared-message table" if mtype ==
                            MSG_SHARED_TABLE else "multi-file layout "
                            "information")
                    raise self.error(f"superblock extension: {name} is not "
                                     "supported")
        self.root = root

    # -- object headers -----------------------------------------------------

    def header(self, addr: int, what: str):
        """The messages ``(type, flags, bytes)`` of the object header at
        ``addr``, continuations followed."""
        first = self.read(addr, 1, f"object header of {what}")
        if first == b"O":
            return self._header_v2(addr, what)
        if first[0] != 1:
            raise self.error(f"object header of {what} at {addr}: version "
                             f"{first[0]} is not supported")
        b = self.buf(addr, 16, f"object header of {what}")
        b.skip(4)                   # version, reserved, message count
        b.skip(4)                   # reference count
        size = b.u32()
        blocks, out = [(addr + 16, size)], []
        while blocks:
            start, size = blocks.pop(0)
            b = self.buf(start, size, f"object header of {what}")
            while b.pos + 8 <= size:
                mtype, msize, flags = b.u16(), b.u16(), b.u8()
                b.skip(3)
                data = b.take(msize)
                if mtype == MSG_CONTINUATION:
                    c = _Buf(self, data, start, f"continuation of {what}")
                    blocks.append((c.addr_(), c.length()))
                elif mtype != MSG_NIL:
                    out.append((mtype, flags, data))
        return out

    def _header_v2(self, addr: int, what: str):
        name = f"OHDR of {what}"
        b = self.buf(addr, 6, name)
        if b.take(4) != b"OHDR":
            raise self.error(f"{name} at {addr}: bad signature")
        version, flags = b.u8(), b.u8()
        if version != 2:
            raise self.error(f"{name} at {addr}: version {version}")
        prefix = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self.read(addr + prefix, width, name), "little")
        b = self.checked(addr, prefix + width + size + 4, name, b"OHDR")
        b.pos = prefix + width
        per = 6 if flags & 0x04 else 4
        out, blocks = [], []
        while True:
            while b.pos + per <= len(b.data):
                mtype, msize, mflags = b.u8(), b.u16(), b.u8()
                if flags & 0x04:
                    b.skip(2)
                data = b.take(msize)
                if mtype == MSG_CONTINUATION:
                    c = _Buf(self, data, b.addr, f"continuation of {what}")
                    blocks.append((c.addr_(), c.length()))
                elif mtype != MSG_NIL:
                    out.append((mtype, mflags, data))
            if not blocks:
                return out
            start, size = blocks.pop(0)
            b = self.checked(start, size, f"OCHK of {what}", b"OCHK")

    # -- heaps --------------------------------------------------------------

    def local_heap(self, addr: int) -> bytes:
        """The data segment of the local heap at ``addr``."""
        if addr not in self.heaps:
            b = self.buf(addr, 8 + 2 * self.sizeof_size + self.sizeof_addr,
                         "local heap")
            if b.take(4) != b"HEAP":
                raise self.error(f"local heap at {addr}: bad signature")
            b.skip(4)
            size = b.length()
            b.length()              # free list
            self.heaps[addr] = self.read(b.addr_(), size,
                                     "local heap data segment")
        return self.heaps[addr]

    def close(self) -> None:
        if self.owned:
            self.fh.close()


def _heap_string(heap: bytes, offset: int) -> bytes:
    end = heap.find(b"\0", offset)
    return heap[offset:end if end >= 0 else len(heap)]


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

class Group:
    """A group: its links by name, read on first use."""

    def __init__(self, f: _File, addr: int, name: str, messages):
        self._f, self._addr, self.name = f, addr, name
        self._messages = messages
        self._links = None

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} of {self._f.name}>"

    # -- links ----------------------------------------------------------------

    def _load_links(self) -> dict:
        """name -> ("hard", address) | ("soft", path) | ("external", ...)."""
        if self._links is not None:
            return self._links
        links, self._order = {}, {}
        for mtype, _, data in self._messages:
            if mtype == MSG_SYMBOL_TABLE:
                btree, heap = self._symbol_table(data)
                for entry in self._walk_group_btree(btree, heap):
                    links.update([self._symbol(entry, heap)])
            elif mtype == MSG_LINK:
                name, link, order = self._link_message(data)
                links[name], self._order[name] = link, order
            elif mtype == MSG_LINK_INFO:
                self._dense_links(data, links)
        self._links = links
        return links

    def _symbol_table(self, data: bytes):
        b = _Buf(self._f, data, self._addr, f"group {self.name}")
        btree, heap = b.addr_(), b.addr_()
        return btree, self._f.local_heap(heap)

    def _symbol(self, b: _Buf, heap: bytes):
        """One symbol-table entry: (name, link)."""
        name_off = b.uint(self._f.sizeof_addr)
        addr = b.addr_()
        cache = b.u32()
        b.skip(4)
        scratch = b.take(16)
        name = _heap_string(heap, name_off).decode("utf-8")
        if cache == 2:
            target = struct.unpack_from("<I", scratch)[0]
            return name, ("soft", _heap_string(heap, target).decode("utf-8"))
        return name, ("hard", addr)

    def _group_node(self, addr: int, heap: bytes):
        """(level, [(child, largest name under it)]) of a group B-tree
        node: child ``i`` holds the names after key ``i`` up to key
        ``i + 1``."""
        f = self._f
        what = f"group B-tree of {self.name}"
        b = f.buf(addr, 8 + 2 * f.sizeof_addr, what)
        if b.take(4) != b"TREE" or b.u8() != 0:
            raise f.error(f"{what} at {addr}: bad signature or node type")
        level, used = b.u8(), b.u16()
        b = f.buf(addr + 8 + 2 * f.sizeof_addr,
                  (used + 1) * f.sizeof_size + used * f.sizeof_addr, what)
        b.length()
        out = []
        for _ in range(used):
            child = b.addr_()
            out.append((child, _heap_string(heap, b.length())))
        return level, out

    def _symbol_node(self, addr: int):
        f = self._f
        s = f.buf(addr, 8, f"symbol node of {self.name}")
        if s.take(4) != b"SNOD":
            raise f.error(f"symbol node of {self.name} at {addr}: bad "
                          "signature")
        s.skip(2)
        count = s.u16()
        size = 2 * f.sizeof_addr + 24
        entries = f.buf(addr + 8, count * size, f"symbol node of {self.name}")
        return [_Buf(f, entries.take(size), addr, "symbol entry")
                for _ in range(count)]

    def _walk_group_btree(self, addr: int, heap: bytes):
        """Every symbol-table entry under the group B-tree at ``addr``."""
        level, children = self._group_node(addr, heap)
        for child, _ in children:
            if level > 0:
                yield from self._walk_group_btree(child, heap)
            else:
                yield from self._symbol_node(child)

    def _search_group_btree(self, addr: int, heap: bytes, key: bytes):
        """The link named ``key`` under the group B-tree at ``addr``, or
        ``None``: one node a level and one symbol node are read."""
        while True:
            level, children = self._group_node(addr, heap)
            child = next((c for c, last in children if key <= last), None)
            if child is None:
                return None
            if level == 0:
                for entry in self._symbol_node(child):
                    name, link = self._symbol(entry, heap)
                    if name.encode("utf-8") == key:
                        return link
                return None
            addr = child

    def _find(self, name: str):
        """The link named ``name`` (``None`` where there is none)."""
        if self._links is None:
            for mtype, _, data in self._messages:
                if mtype == MSG_SYMBOL_TABLE:
                    btree, heap = self._symbol_table(data)
                    return self._search_group_btree(btree, heap,
                                                    name.encode("utf-8"))
        return self._load_links().get(name)

    def _link_message(self, data: bytes):
        """(name, link, creation order or None) of a link message."""
        f = self._f
        b = _Buf(f, data, self._addr, f"link message of {self.name}")
        b.u8()
        flags = b.u8()
        kind = b.u8() if flags & 0x08 else 0
        order = b.uint(8) if flags & 0x04 else None
        if flags & 0x10:
            b.skip(1)
        name = b.take(b.uint(1 << (flags & 3))).decode("utf-8")
        if kind == 0:
            return name, ("hard", b.addr_()), order
        if kind == 1:
            return name, ("soft", b.take(b.u16()).decode("utf-8")), order
        if kind == 64:
            raw = b.take(b.u16())[1:].split(b"\0")
            return name, ("external", raw[0].decode("utf-8", "replace"),
                          raw[1].decode("utf-8", "replace")
                          if len(raw) > 1 else ""), order
        return name, ("user", kind), order

    def _dense_links(self, data: bytes, links: dict) -> None:
        """Links in a fractal heap, found through the name index."""
        f = self._f
        b = _Buf(f, data, self._addr, f"link info of {self.name}")
        b.u8()
        flags = b.u8()
        if flags & 1:
            b.skip(8)
        heap_addr, name_index = b.addr_(), b.addr_()
        if heap_addr is None:
            return
        heap = _FractalHeap(f, heap_addr, self.name)
        for record in _btree_v2_records(f, name_index, 5,
                                        f"link name index of {self.name}"):
            name, link, order = self._link_message(heap.get(record[4:]))
            links[name], self._order[name] = link, order

    # -- the API --------------------------------------------------------------

    def keys(self) -> list:
        """Member names in h5py's order: by creation order where the group
        tracks it, else by name, byte for byte."""
        links = self._load_links()
        if links and all(self._order.get(k) is not None for k in links):
            return sorted(links, key=self._order.__getitem__)
        return sorted(links, key=lambda s: s.encode("utf-8"))

    def __contains__(self, name) -> bool:
        try:
            self._resolve(name)
        except KeyError:
            return False
        return True

    def __getitem__(self, name: str):
        return self._resolve(name)

    def _child(self, key: str, depth: int):
        link = self._find(key)
        path = self.name.rstrip("/") + "/" + key
        if link is None:
            raise KeyError(f"{path!r} is not in {self._f.name}")
        if link[0] == "soft":
            if depth > 16:
                raise KeyError(f"{path!r} in {self._f.name}: too many soft "
                               "links")
            return self._resolve(link[1], depth + 1)
        if link[0] == "external":
            raise ValueError(f"{self._f.name}: {path!r} is an external link "
                             f"to {link[1]}:{link[2]}, which is not "
                             "supported")
        if link[0] != "hard" or link[1] is None:
            raise ValueError(f"{self._f.name}: {path!r} is a link of type "
                             f"{link[1]}, which is not supported")
        return _open_object(self._f, link[1], path)

    def _resolve(self, name: str, depth: int = 0):
        if not isinstance(name, str):
            raise TypeError(f"an HDF5 name is a str, not {type(name)}")
        node = _open_object(self._f, self._f.root, "/") \
            if name.startswith("/") else self
        for part in name.split("/"):
            if part in ("", "."):
                continue
            if not isinstance(node, Group):
                raise KeyError(f"{name!r} in {self._f.name}: {node.name!r} "
                               "is not a group")
            node = node._child(part, depth)
        return node


def _open_object(f: _File, addr: int, name: str):
    messages = f.header(addr, name)
    types = {m[0] for m in messages}
    if types & {MSG_SYMBOL_TABLE, MSG_LINK_INFO, MSG_LINK, MSG_GROUP_INFO}:
        return Group(f, addr, name, messages)
    if MSG_LAYOUT in types:
        return Dataset(f, name, messages)
    raise ValueError(f"{f.name}: {name!r} is neither a group nor a dataset "
                     "(a committed datatype?)")


# ---------------------------------------------------------------------------
# fractal heaps and version 2 B-trees
# ---------------------------------------------------------------------------

def _enc_size(limit: int) -> int:
    """Bytes that hold numbers up to ``limit`` (``H5VM_limit_enc_size``)."""
    return max(limit, 1).bit_length() // 8 + 1 if limit else 1


class _FractalHeap:
    """A fractal heap's managed and tiny objects (the links of a dense
    group); huge objects and filtered blocks are refused."""

    def __init__(self, f: _File, addr: int, owner: str):
        self.f, self.owner = f, owner
        what = f"fractal heap of {owner}"
        prefix = 26 + 12 * f.sizeof_size + 3 * f.sizeof_addr
        head = f.read(addr, prefix, what)
        b = _Buf(f, head, addr, what)
        if b.take(4) != b"FRHP":
            raise f.error(f"{what} at {addr}: bad signature")
        b.skip(3)                   # version, heap id length
        filter_len, flags, max_managed = b.u16(), b.u8(), b.u32()
        b.length()                  # next huge object id
        b.addr_()                   # B-tree of huge objects
        b.length()                  # free space in managed blocks
        b.addr_()                   # its manager
        for _ in range(8):          # managed, allocated, iterator, counts
            b.length()
        self.width = b.u16()
        self.start_block, self.max_direct = b.length(), b.length()
        max_heap_bits = b.u16()
        b.u16()                     # starting rows of the root block
        self.root = b.addr_()
        self.root_rows = b.u16()
        if filter_len:
            raise f.error(f"{what}: filtered heap blocks are not supported")
        f.checked(addr, b.pos + 4, what, b"FRHP")
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min(_enc_size(self.max_direct),
                            _enc_size(max_managed))
        self.max_direct_rows = (self.max_direct.bit_length()
                                - self.start_block.bit_length()) + 2
        self.checksummed = bool(flags & 2)
        self.blocks = {}

    def block_size(self, row: int) -> int:
        return self.start_block << max(row - 1, 0)

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:                       # tiny: the object is the id
            return heap_id[1:1 + (heap_id[0] & 0x0F) + 1]
        if kind != 0:
            raise self.f.error(f"fractal heap of {self.owner}: a huge object "
                               "is not supported")
        off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        size = int.from_bytes(
            heap_id[1 + self.off_size:1 + self.off_size + self.len_size],
            "little")
        if self.root_rows == 0:             # the root is one direct block
            return self._direct(self.root, 0, self.start_block, off, size)
        return self._indirect(self.root, self.root_rows, 0, off, size)

    def _direct(self, addr, block_off, block_size, off, size) -> bytes:
        """Object bytes of the direct block at ``addr``, read whole once
        and its checksum (over the block, the checksum field zeroed)
        verified where the heap has them."""
        what = f"FHDB of {self.owner}"
        if addr not in self.blocks:
            data = bytearray(self.f.read(addr, block_size, what))
            if data[:4] != b"FHDB":
                raise self.f.error(f"{what} at {addr}: bad signature")
            if self.checksummed:
                at = 5 + self.f.sizeof_addr + self.off_size
                want = struct.unpack_from("<I", data, at)[0]
                data[at:at + 4] = bytes(4)
                if lookup3(data) != want:
                    raise self.f.error(f"{what} at {addr}: checksum mismatch")
            self.blocks[addr] = bytes(data)
        lo = off - block_off
        if lo < 0 or lo + size > block_size:
            raise self.f.error(f"{what} at {addr}: object offset {off}")
        return self.blocks[addr][lo:lo + size]

    def _indirect(self, addr, rows, block_off, off, size) -> bytes:
        f = self.f
        what = f"fractal heap indirect block of {self.owner}"
        n_direct = min(rows, self.max_direct_rows) * self.width
        n_indirect = max(rows - self.max_direct_rows, 0) * self.width
        n = (5 + f.sizeof_addr + self.off_size
             + (n_direct + n_indirect) * f.sizeof_addr + 4)
        b = f.checked(addr, n, what, b"FHIB")
        b.skip(1 + f.sizeof_addr + self.off_size)
        entries = [b.addr_() for _ in range(n_direct + n_indirect)]
        start = block_off
        for row in range(rows):
            bsize = self.block_size(row)
            for col in range(self.width):
                if start <= off < start + bsize:
                    child = entries[row * self.width + col]
                    if child is None:
                        raise f.error(f"{what} at {addr}: object offset "
                                      f"{off} in an unallocated block")
                    if row < self.max_direct_rows:
                        return self._direct(child, start, bsize, off, size)
                    sub_rows = (bsize.bit_length()
                                - (self.start_block * self.width
                                   ).bit_length()) + 1
                    return self._indirect(child, sub_rows, start, off, size)
                start += bsize
        raise f.error(f"{what} at {addr}: object offset {off} past the block")


def _btree_v2_records(f: _File, addr: int, rtype: int, what: str):
    """Every record (bytes) of the version 2 B-tree at ``addr``, in order."""
    b = f.checked(addr, 16 + f.sizeof_addr + 2 + f.sizeof_size + 4,
                  f"BTHD of {what}", b"BTHD")
    b.u8()
    if b.u8() != rtype:
        raise f.error(f"BTHD of {what} at {addr}: record type is not {rtype}")
    node_size, rec_size, depth = b.u32(), b.u16(), b.u16()
    b.skip(2)
    root, root_n = b.addr_(), b.u16()
    if root is None:
        return []
    # records a node holds, and the bytes of each child pointer's counts
    leaf_max = (node_size - 10) // rec_size
    n_size = _enc_size(leaf_max)
    cum_max, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = f.sizeof_addr + n_size + (cum_size[d - 1] if d > 1 else 0)
        max_rec = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum_max.append((max_rec + 1) * cum_max[d - 1] + max_rec)
        cum_size.append(_enc_size(cum_max[d]))
    out = []

    def walk(node, count, d):
        if d == 0:
            c = f.checked(node, 6 + count * rec_size + 4, f"BTLF of {what}",
                          b"BTLF")
            c.skip(2)
            out.extend(c.take(rec_size) for _ in range(count))
            return
        ptr = f.sizeof_addr + n_size + (cum_size[d - 1] if d > 1 else 0)
        c = f.checked(node, 6 + count * rec_size + (count + 1) * ptr + 4,
                      f"BTIN of {what}", b"BTIN")
        c.skip(2)
        records = [c.take(rec_size) for _ in range(count)]
        children = []
        for _ in range(count + 1):
            child, k = c.addr_(), c.uint(n_size)
            if d > 1:
                c.uint(cum_size[d - 1])
            children.append((child, k))
        for i, (child, k) in enumerate(children):
            walk(child, k, d - 1)
            if i < count:
                out.append(records[i])

    walk(root, root_n, depth)
    return out


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

class Dataset:
    """A numeric dataset: its shape, dtype and storage, read by ``read``."""

    def __init__(self, f: _File, name: str, messages):
        self._f, self.name = f, name
        self._layout = self._filters = None
        self._fill = self._fill_old = None
        self.shape = self._maxshape = None
        for mtype, flags, data in messages:
            if flags & 0x02 and mtype in (MSG_DATATYPE, MSG_DATASPACE,
                                          MSG_FILL, MSG_FILTERS, MSG_LAYOUT):
                raise ValueError(f"{f.name}: dataset {name!r}: shared "
                                 f"message {mtype} is not supported")
            if mtype == MSG_DATASPACE:
                self._dataspace(data)
            elif mtype == MSG_DATATYPE:
                self._datatype(data)
            elif mtype == MSG_FILL_OLD:
                size = struct.unpack_from("<I", data)[0]
                self._fill_old = data[4:4 + size]
            elif mtype == MSG_FILL:
                self._fill = self._fill_value(data)
            elif mtype == MSG_LAYOUT:
                self._layout = data
            elif mtype == MSG_FILTERS:
                self._filters = self._pipeline(data)
            elif mtype == MSG_EXTERNAL:
                raise ValueError(f"{f.name}: dataset {name!r}: external "
                                 "storage (an external-files message) is "
                                 "not supported")
        self._parse_layout()

    def __repr__(self) -> str:
        return (f"<HDF5 dataset {self.name!r}: shape {self.shape}, "
                f"{self.dtype}>")

    def _err(self, msg: str, kind=ValueError):
        return kind(f"{self._f.name}: dataset {self.name!r}: {msg}")

    # -- messages -------------------------------------------------------------

    def _dataspace(self, data: bytes) -> None:
        b = _Buf(self._f, data, 0, f"dataspace of {self.name}")
        version, rank, flags = b.u8(), b.u8(), b.u8()
        if version == 1:
            b.skip(5)
            kind = 1 if rank else 0
        elif version == 2:
            kind = b.u8()
        else:
            raise self._err(f"dataspace message version {version}")
        dims = tuple(b.length() for _ in range(rank))
        maxdims = tuple(b.length() for _ in range(rank)) if flags & 1 \
            else dims
        self.shape = None if kind == 2 else dims
        self._maxshape = maxdims

    def _datatype(self, data: bytes) -> None:
        cls = data[0] & 0x0F
        bits = data[1] | data[2] << 8 | data[3] << 16
        size = struct.unpack_from("<I", data, 4)[0]
        name = DATATYPE_CLASSES.get(cls, f"class {cls}")
        order = ">" if bits & 1 else "<"
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", data, 8)
            ok = size in (1, 2, 4, 8) and offset == 0 and \
                precision == 8 * size
            kind = "i" if bits & 0x08 else "u"
        elif cls == 1:
            offset, precision, eloc, esize, mloc, msize = struct.unpack_from(
                "<HHBBBB", data, 8)
            bias = struct.unpack_from("<I", data, 16)[0]
            ok = (size in IEEE and offset == 0 and precision == 8 * size
                  and not bits & 0x40 and (bits >> 4) & 3 == 2 and mloc == 0
                  and (eloc, esize, msize, bias) == IEEE[size])
            kind = "f"
        else:
            raise self._err(f"datatype class {cls} ({name}) is not "
                            "supported: only fixed-point and floating-point "
                            "numbers are read")
        if not ok:
            raise self._err(f"{name} datatype of {size} bytes with this bit "
                            "layout is not supported")
        self.dtype = np.dtype(f"{order}{kind}{size}")

    def _fill_value(self, data: bytes):
        version = data[0]
        if version in (1, 2):
            defined = data[3]
            if version == 1 or defined:
                size = struct.unpack_from("<I", data, 4)[0]
                return data[8:8 + size]
            return b""
        if version == 3:
            flags = data[1]
            if flags & 0x20:
                size = struct.unpack_from("<I", data, 2)[0]
                return data[6:6 + size]
            return b""
        raise self._err(f"fill-value message version {version}")

    def _pipeline(self, data: bytes):
        b = _Buf(self._f, data, 0, f"filter pipeline of {self.name}")
        version, n = b.u8(), b.u8()
        if version == 1:
            b.skip(6)
        elif version != 2:
            raise self._err(f"filter pipeline message version {version}")
        out = []
        for _ in range(n):
            fid = b.u16()
            name_len = b.u16() if version == 1 or fid >= 256 else 0
            flags, nvalues = b.u16(), b.u16()
            raw = b.take(((name_len + 7) & ~7) if version == 1 else name_len)
            name = raw.split(b"\0")[0].decode("utf-8", "replace")
            values = [b.u32() for _ in range(nvalues)]
            if version == 1 and nvalues % 2:
                b.skip(4)
            out.append((fid, FILTER_NAMES.get(fid, name or "unknown"),
                        flags, values))
        return out

    def _parse_layout(self) -> None:
        if self._layout is None:
            raise self._err("no data layout message")
        b = _Buf(self._f, self._layout, 0, f"data layout of {self.name}")
        version, cls = b.u8(), b.u8()
        if version not in (3, 4):
            raise self._err(f"data layout message version {version} is not "
                            "supported")
        self._cls = cls
        if cls == 0:
            self._compact = b.take(b.u16())
        elif cls == 1:
            self._address = b.addr_()
        elif cls == 2:
            if version == 3:
                rank = b.u8()
                self._btree = b.addr_()
                dims = [b.u32() for _ in range(rank)]
                self._index, self._chunk_flags = "btree1", 0
            else:
                self._chunk_flags = b.u8()
                rank, width = b.u8(), b.u8()
                dims = [b.uint(width) for _ in range(rank)]
                itype = b.u8()
                self._index = {1: "single", 2: "implicit", 3: "farray",
                               4: "earray", 5: "btree2"}.get(itype)
                if self._index is None:
                    raise self._err(f"chunk index type {itype}")
                if itype == 1 and self._chunk_flags & 2:
                    self._single = (b.length(), b.u32())
                elif itype == 3:
                    b.u8()
                elif itype == 4:
                    b.skip(5)
                elif itype == 5:
                    b.skip(6)
                self._btree = b.addr_()
            self._chunk = tuple(dims[:-1])
        elif cls == 3:
            raise self._err("a virtual dataset (layout class 3) is not "
                            "supported")
        else:
            raise self._err(f"layout class {cls}")

    # -- reading --------------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out if dtype is None else out.astype(dtype, copy=False)

    def _fill_array(self, out: np.ndarray) -> None:
        fill = self._fill if self._fill is not None else self._fill_old
        out[...] = np.frombuffer(fill[:self.dtype.itemsize], self.dtype)[0] \
            if fill else 0

    def read(self) -> np.ndarray:
        """The whole dataset as one array (h5py's dtype; a null dataspace
        gives an empty array)."""
        if self.shape is None:
            return np.empty((0,), self.dtype)
        out = np.empty(self.shape, self.dtype)
        if out.size == 0:
            return out
        if self._cls == 0:
            n = out.nbytes
            if len(self._compact) < n:
                raise self._err("compact data shorter than the dataset",
                                OSError)
            out.reshape(-1).view(np.uint8)[...] = np.frombuffer(
                self._compact[:n], np.uint8)
        elif self._cls == 1:
            if self._address is None:
                self._fill_array(out)
            else:
                self._f.readinto(self._address,
                                 memoryview(out.reshape(-1).view(np.uint8)),
                                 f"data of dataset {self.name!r}")
        else:
            self._read_chunks(out)
        return out

    def _linear(self, unlimited):
        """(scaled coordinates, index) of every chunk of the extent, the
        index linear over the chunk grid of the maximal extent (of an
        extensible array: the unlimited axis moved first, where it alone
        may grow)."""
        rank = len(self.shape)
        order = list(range(rank)) if unlimited is None else \
            [unlimited] + [d for d in range(rank) if d != unlimited]
        stride, strides = 1, {}
        for d in reversed(order):
            strides[d] = stride
            if d != unlimited:
                stride *= -(-self._maxshape[d] // self._chunk[d])
        counts = [range(-(-n // c)) for n, c in zip(self.shape, self._chunk)]
        for coords in itertools.product(*counts):
            yield coords, sum(c * strides[d] for d, c in enumerate(coords))

    def _chunks(self):
        """(scaled chunk coordinates, address, stored bytes or None,
        filter mask) of every allocated chunk."""
        f, rank = self._f, len(self.shape)
        nbytes = int(np.prod(self._chunk)) * self.dtype.itemsize
        size_len = min(1 + (nbytes.bit_length() - 1 + 8) // 8, 8)
        filtered = bool(self._filters)
        index = self._index
        if self._btree is None:
            return
        if index == "btree1":
            yield from self._walk_chunk_btree(self._btree, rank)
        elif index == "single":
            size, mask = self._single if self._chunk_flags & 2 else (None, 0)
            yield (0,) * rank, self._btree, size, mask
        elif index == "implicit":
            for coords, lin in self._linear(None):
                yield coords, self._btree + lin * nbytes, None, 0
        elif index == "farray":
            entries = _FixedArray(f, self._btree, self.name, filtered,
                                  size_len)
            for coords, lin in self._linear(None):
                entry = entries.get(lin)
                if entry is not None:
                    yield (coords, *entry)
        elif index == "earray":
            entries = _ExtensibleArray(f, self._btree, self.name, filtered,
                                       size_len)
            for coords, lin in self._linear(
                    self._maxshape.index(UNLIMITED)):
                entry = entries.get(lin)
                if entry is not None:
                    yield (coords, *entry)
        elif index == "btree2":
            rtype = 11 if filtered else 10
            for rec in _btree_v2_records(f, self._btree, rtype,
                                         f"chunk index of {self.name}"):
                r = _Buf(f, rec, self._btree, f"chunk record of {self.name}")
                addr = r.addr_()
                size, mask = (r.uint(size_len), r.u32()) if filtered \
                    else (None, 0)
                coords = tuple(r.uint(8) for _ in range(rank))
                if addr is not None:
                    yield coords, addr, size, mask

    def _walk_chunk_btree(self, addr: int, rank: int):
        f = self._f
        what = f"chunk B-tree of dataset {self.name!r}"
        b = f.buf(addr, 8 + 2 * f.sizeof_addr, what)
        if b.take(4) != b"TREE" or b.u8() != 1:
            raise f.error(f"{what} at {addr}: bad signature or node type")
        level, used = b.u8(), b.u16()
        key = 8 + 8 * (rank + 1)
        b = f.buf(addr + 8 + 2 * f.sizeof_addr,
                  (used + 1) * key + used * f.sizeof_addr, what)
        for _ in range(used):
            size, mask = b.u32(), b.u32()
            offsets = tuple(b.uint(8) for _ in range(rank + 1))
            child = b.addr_()
            if level > 0:
                yield from self._walk_chunk_btree(child, rank)
            else:
                yield (tuple(o // c for o, c in zip(offsets, self._chunk)),
                       child, size, mask)

    def _read_chunks(self, out: np.ndarray) -> None:
        chunk = self._chunk
        nbytes = int(np.prod(chunk)) * self.dtype.itemsize
        total = int(np.prod([-(-d // c) for d, c in zip(self.shape, chunk)]))
        chunks = [c for c in self._chunks()
                  if all(k * n < d for k, n, d in zip(c[0], chunk,
                                                       self.shape))]
        if len(chunks) < total:
            # chunks never written read as the fill value
            self._fill_array(out)
        for coords, addr, size, mask in chunks:
            lo = [k * n for k, n in zip(coords, chunk)]
            hi = [min(a + n, d) for a, n, d in zip(lo, chunk, self.shape)]
            edge = any(b - a < n for a, b, n in zip(lo, hi, chunk))
            where = f"chunk {tuple(coords)}"
            raw = self._f.read(addr, nbytes if size is None else size,
                               f"{where} of dataset {self.name!r}")
            if self._filters and not (edge and self._chunk_flags & 1):
                raw = self._unfilter(raw, mask, nbytes, where)
            if len(raw) != nbytes:
                raise self._err(f"{where} holds {len(raw)} bytes, expected "
                                f"{nbytes}")
            block = np.frombuffer(raw, self.dtype).reshape(chunk)
            out[tuple(slice(a, b) for a, b in zip(lo, hi))] = block[
                tuple(slice(0, b - a) for a, b in zip(lo, hi))]

    def _unfilter(self, raw: bytes, mask: int, nbytes: int, where: str):
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, name, _, values = self._filters[i]
            if fid == 1:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise self._err(f"{where}: deflate failed: {e}") from e
            elif fid == 2:
                raw = unshuffle(raw, values[0] if values else
                                self.dtype.itemsize)
            elif fid == 3:
                if len(raw) < 4:
                    raise self._err(f"{where}: fletcher32: chunk too short")
                body, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
                got = fletcher32(body)
                swapped = ((got & 0x00FF00FF) << 8 | (got >> 8) & 0x00FF00FF)
                if stored not in (got, swapped):
                    raise self._err(f"{where}: fletcher32 checksum mismatch "
                                    f"(stored {stored:#010x}, computed "
                                    f"{got:#010x})")
                raw = body
            elif fid == 32000:
                try:
                    raw = lzf_decompress(raw, nbytes)
                except (ValueError, IndexError) as e:
                    raise self._err(f"{where}: lzf failed: {e}") from e
            else:
                raise self._err(f"filter {fid} ({name}) is not supported")
        return raw


class _FixedArray:
    """The entries of a fixed-array chunk index (``FAHD``/``FADB``); past
    2**page_bits entries the data block is paged, and a page never written
    holds no chunk."""

    def __init__(self, f: _File, addr: int, owner: str, filtered: bool,
                 size_len: int):
        self.f, self.filtered, self.size_len = f, filtered, size_len
        self.what = f"FADB of {owner}"
        b = f.checked(addr, 8 + f.sizeof_size + f.sizeof_addr + 4,
                      f"FAHD of {owner}", b"FAHD")
        b.skip(2)
        self.esize, page_bits = b.u8(), b.u8()
        self.n = b.length()
        dblock = b.addr_()
        self.page = 1 << page_bits
        self.pages = {}
        if dblock is None:
            self.n = 0
            return
        self.paged = self.n > self.page
        npages = -(-self.n // self.page) if self.paged else 0
        prefix = 6 + f.sizeof_addr + (npages + 7) // 8
        if not self.paged:
            b = f.checked(dblock, prefix + self.n * self.esize + 4,
                          self.what, b"FADB")
            self.pages[0] = b.data[prefix:]
            return
        b = f.checked(dblock, prefix + 4, self.what, b"FADB")
        b.pos = 6 + f.sizeof_addr
        self.bits = b.take(prefix - b.pos)
        self.start = dblock + prefix + 4

    def _page(self, p: int):
        if p not in self.pages:
            if not self.bits[p // 8] & (0x80 >> (p % 8)):
                self.pages[p] = None        # never written: no chunk
            else:
                count = min(self.page, self.n - p * self.page)
                addr = self.start + p * (self.page * self.esize + 4)
                data = self.f.read(addr, count * self.esize + 4, self.what)
                if lookup3(data[:-4]) != struct.unpack_from(
                        "<I", data, len(data) - 4)[0]:
                    raise self.f.error(f"{self.what} page {p} at {addr}: "
                                       "checksum mismatch")
                self.pages[p] = data[:-4]
        return self.pages[p]

    def get(self, i: int):
        if i >= self.n:
            return None
        p, k = divmod(i, self.page) if self.paged else (0, i)
        data = self._page(p) if self.paged else self.pages[0]
        if data is None:
            return None
        return _entry(_Buf(self.f, data[k * self.esize:(k + 1) * self.esize],
                           0, self.what), self.filtered, self.size_len)


def _entry(b: _Buf, filtered: bool, size_len: int):
    addr = b.addr_()
    if filtered:
        size, mask = b.uint(size_len), b.u32()
    else:
        size, mask = None, 0
    return None if addr is None else (addr, size, mask)


class _ExtensibleArray:
    """The entries of an extensible-array chunk index (``EAHD``, ``EAIB``,
    ``EASB``, ``EADB``)."""

    def __init__(self, f: _File, addr: int, owner: str, filtered: bool,
                 size_len: int):
        self.f, self.owner = f, owner
        self.filtered, self.size_len = filtered, size_len
        what = f"EAHD of {owner}"
        b = f.checked(addr, 12 + 6 * f.sizeof_size + f.sizeof_addr + 4,
                      what, b"EAHD")
        b.skip(2)
        self.esize, max_bits, self.idx_elmts = b.u8(), b.u8(), b.u8()
        self.dblk_min, sblk_min_ptrs, page_bits = b.u8(), b.u8(), b.u8()
        for _ in range(6):
            b.length()
        iblock = b.addr_()
        self.page = 1 << page_bits
        self.off_size = (max_bits + 7) // 8
        nsblks = 1 + max_bits - (self.dblk_min.bit_length() - 1)
        # per super block: data blocks, elements a block, first element and
        # first data block
        self.sblk = []
        start = dstart = 0
        for u in range(nsblks):
            nd, ne = 1 << (u // 2), (1 << ((u + 1) // 2)) * self.dblk_min
            self.sblk.append((nd, ne, start, dstart))
            start += nd * ne
            dstart += nd
        self.iblock_sblks = 2 * (sblk_min_ptrs.bit_length() - 1)
        n_dblk = 2 * (sblk_min_ptrs - 1)
        n_sblk = nsblks - self.iblock_sblks
        self.iblock = None
        if iblock is None:
            return
        n = (6 + f.sizeof_addr + self.idx_elmts * self.esize
             + (n_dblk + n_sblk) * f.sizeof_addr + 4)
        b = f.checked(iblock, n, f"EAIB of {owner}", b"EAIB")
        b.pos = 6 + f.sizeof_addr
        self.elmts = b.take(self.idx_elmts * self.esize)
        self.dblk_addrs = [b.addr_() for _ in range(n_dblk)]
        self.sblk_addrs = [b.addr_() for _ in range(n_sblk)]
        self.iblock = iblock
        self.cache = {}

    def _parse(self, raw: bytes, k: int):
        return _entry(_Buf(self.f, raw[k * self.esize:(k + 1) * self.esize],
                           0, f"chunk index of {self.owner}"),
                      self.filtered, self.size_len)

    def _dblock(self, addr, nelmts, bits=None, bit0=0):
        """The element bytes of the data block at ``addr`` (pages that
        were never written read as ``None`` entries)."""
        key = ("d", addr)
        if key in self.cache:
            return self.cache[key]
        f = self.f
        what = f"EADB of {self.owner}"
        prefix = 6 + f.sizeof_addr + self.off_size
        if nelmts <= self.page:
            b = f.checked(addr, prefix + nelmts * self.esize + 4, what,
                          b"EADB")
            out = [b.data[prefix:]]
        else:
            b = f.checked(addr, prefix + 4, what, b"EADB")
            out = []
            size = self.page * self.esize + 4
            for p in range(nelmts // self.page):
                at = bit0 + p               # the super block's page map
                if bits is not None and not bits[at // 8] & (0x80 >> (at % 8)):
                    out.append(None)
                    continue
                pg = f.read(addr + prefix + 4 + p * size, size, what + " page")
                if lookup3(pg[:-4]) != struct.unpack_from("<I", pg,
                                                          size - 4)[0]:
                    raise f.error(f"{what} page {p} at {addr}: checksum "
                                  "mismatch")
                out.append(pg[:-4])
        self.cache[key] = out
        return out

    def _sblock(self, addr, u):
        key = ("s", addr)
        if key in self.cache:
            return self.cache[key]
        f = self.f
        nd, ne, _, _ = self.sblk[u]
        npages = ne // self.page if ne > self.page else 0
        bitmap = nd * ((npages + 7) // 8)
        b = f.checked(addr, 6 + f.sizeof_addr + self.off_size + bitmap
                      + nd * f.sizeof_addr + 4, f"EASB of {self.owner}",
                      b"EASB")
        b.pos = 6 + f.sizeof_addr + self.off_size
        bits = b.take(bitmap) if bitmap else None
        out = (bits, [b.addr_() for _ in range(nd)])
        self.cache[key] = out
        return out

    def get(self, i: int):
        if self.iblock is None:
            return None
        if i < self.idx_elmts:
            return self._parse(self.elmts, i)
        j = i - self.idx_elmts
        u = (j // self.dblk_min + 1).bit_length() - 1
        nd, ne, start, dstart = self.sblk[u]
        d, k = divmod(j - start, ne)
        bits = None
        if u < self.iblock_sblks:
            addr = self.dblk_addrs[dstart + d]
        else:
            saddr = self.sblk_addrs[u - self.iblock_sblks]
            if saddr is None:
                return None
            bits, addrs = self._sblock(saddr, u)
            addr = addrs[d]
        if addr is None:
            return None
        npages = ne // self.page if ne > self.page else 0
        pages = self._dblock(addr, ne, bits, d * npages)
        p, k = divmod(k, self.page) if npages else (0, k)
        if pages[p] is None:
            return None
        return self._parse(pages[p], k)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

class File(Group):
    """An HDF5 file opened for reading (``path`` or a binary file object
    with ``seek``, ``tell`` and ``readinto``); the root group."""

    def __init__(self, path_or_fileobj):
        if isinstance(path_or_fileobj, (str, os.PathLike)):
            name = os.fspath(path_or_fileobj)
            fh, owned = open(name, "rb", buffering=0), True
        else:
            fh, owned = path_or_fileobj, False
            name = str(getattr(fh, "name", repr(fh)))
        try:
            f = _File(fh, name, owned)
            root = _open_object(f, f.root, "/")
        except BaseException:
            if owned:
                fh.close()
            raise
        if not isinstance(root, Group):
            f.close()
            raise ValueError(f"{name}: the root object is not a group")
        super().__init__(f, f.root, "/", root._messages)

    def __repr__(self) -> str:
        return f"<HDF5 file {self._f.name!r}>"

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
