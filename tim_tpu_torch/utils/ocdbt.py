"""Tensorstore's OCDBT key-value store (the ``ocdbt`` kvstore that orbax
checkpoints sit on), read and written with numpy and ``utils.zstd``
only.

A store is a directory: ``manifest.ocdbt`` and files under ``d/``. Each
manifest and each B-tree node is an envelope::

    magic      uint32 big-endian  0x0cdb3a2a (manifest), 0x0cdb20de (node)
    length     uint64 LE          bytes of the envelope, crc included
    version    varint             0
    compression varint            0 none, 1 zstd (the rest is one frame)
    body
    crc32c     uint32 LE          of every byte before it

Integers in a body are LEB128 varints unless named otherwise; a list of
records is stored column by column (every record's first field, then
every record's second field, ...).

- A data file table: ``n``, the length each path shares with the one
  before it (``n - 1``), each path's remaining length, each path's base
  length (the leading part that names another store's directory, as
  ``ocdbt.process_0/``), then the remaining bytes. A path is relative to
  the directory of the manifest the tree hangs from.
- The manifest: a config (uuid[16], manifest kind 0 "single", max inline
  value bytes, max decoded node bytes, version tree arity log2 (uint8),
  compression 1 zstd + level (int32 LE)), a data file table, the newest
  leaf of the version tree (``n`` versions: generation, root height
  (uint8), root file, offset, length, key count, tree bytes, indirect
  value bytes, commit time (uint64 LE ns)), then references to older
  version tree nodes, which the reader does not need. A root length of
  2**64 - 1 is the empty tree.
- A B-tree node: height (uint8), a data file table, ``n`` entries, each
  key's length shared with the key before it (``n - 1``), each key's
  remaining length, [interior: each child's common key prefix length],
  the key bytes; a leaf then has each value's length, each value's kind
  (0 inline, 1 in a data file), the file and offset of each value kept in
  a file, and the inline values in order; an interior node has each
  child's file, offset, length, key count, tree bytes and indirect value
  bytes. Keys in a node omit the prefix shared by its whole subtree,
  which the parent's entry gives.

``read_store(dir)`` returns every key of the newest version and its value
(a ``memoryview`` of a memory-mapped data file or of a node; each file is
mapped once and sliced). A bad envelope (magic, length, crc32c, zstd), a
reference past the end of a file, a missing file or a key count that
disagrees raises ``ValueError`` naming the file and the key (or the first
key of the subtree).

``write_store(dir, items)`` writes one process's store as orbax's
one-process save lays it out: the values longer than
``MAX_INLINE_VALUE_BYTES`` in one data file ``ocdbt.process_0/d/<hex>``,
a leaf (or, past ``MAX_DECODED_NODE_BYTES``, leaves under one interior
node) and a manifest in ``ocdbt.process_0/``, and the root manifest and
nodes in ``d/`` that reference the same data file.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from tim_tpu_torch.utils import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MISSING = 2 ** 64 - 1
MAX_INLINE_VALUE_BYTES = 1024            # orbax's OCDBT config
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
PROCESS = "ocdbt.process_0"              # a one-process save's store


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t


_CRC_TABLE = [int(x) for x in _crc_table()]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in memoryview(data).cast("B"):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, buf, what: str):
        self.buf, self.pos, self.what = memoryview(buf).cast("B"), 0, what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg} at byte {self.pos}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail(f"{n} bytes wanted, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def fixed(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} bytes left over")


def _unwrap(buf, magic: int, what: str) -> memoryview:
    """The body of one envelope, checked and decompressed."""
    buf = memoryview(buf).cast("B")
    if len(buf) < 18:
        raise ValueError(f"{what}: {len(buf)} bytes is too short")
    got = struct.unpack(">I", buf[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, {magic:#010x} "
                         f"expected")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        raise ValueError(f"{what}: {len(buf)} bytes, the header says "
                         f"{length}")
    want = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != want:
        raise ValueError(f"{what}: crc32c mismatch")
    cur = _Cursor(buf[:-4], what)
    cur.pos = 12
    if cur.varint() != 0:
        raise ValueError(f"{what}: unknown format version")
    compression = cur.varint()
    body = buf[cur.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise ValueError(f"{what}: unknown compression {compression}")
    try:
        return memoryview(zstd.decompress(body,
                                          limit=MAX_DECODED_NODE_BYTES))
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def _read_files(cur: _Cursor) -> List[str]:
    n = cur.varint()
    shared = cur.varints(n - 1) if n else []
    rest = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:shared[i - 1]] if i else b""
        path += bytes(cur.take(rest[i]))
        if base[i] > len(path):
            cur.fail(f"base path of {base[i]} bytes in {path!r}")
        paths.append(path.decode())
        prev = path
    return paths


def _read_keys(cur: _Cursor, n: int, interior: bool
               ) -> Tuple[List[bytes], List[int]]:
    shared = cur.varints(n - 1) if n else []
    rest = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        key = (prev[:shared[i - 1]] if i else b"") + bytes(cur.take(rest[i]))
        keys.append(key)
        prev = key
    return keys, common


class _Reader:
    """The files of one store, each mapped once."""

    def __init__(self, root: str, locations: Optional[dict] = None):
        self.root, self.files, self.locations = root, {}, locations

    def file(self, rel: str) -> np.ndarray:
        if rel not in self.files:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise ValueError(f"{path}: missing")
            self.files[rel] = (np.memmap(path, np.uint8, "r")
                               if os.path.getsize(path)
                               else np.zeros(0, np.uint8))
        return self.files[rel]

    def slice(self, rel: str, offset: int, length: int, what: str
              ) -> memoryview:
        data = self.file(rel)
        if offset + length > data.nbytes:
            raise ValueError(
                f"{what}: {rel}[{offset}:{offset + length}] lies past the "
                f"end of the file ({data.nbytes} bytes)")
        return memoryview(data[offset:offset + length])

    def node(self, rel, offset, length, height, prefix: bytes,
             out: Dict[str, memoryview]) -> int:
        """Add the keys under one node to ``out``; their count."""
        first = prefix.decode(errors="replace") or "(the first key)"
        what = f"{os.path.join(self.root, rel)}@{offset} (keys from {first})"
        cur = _Cursor(_unwrap(self.slice(rel, offset, length, what),
                              NODE_MAGIC, what), what)
        if cur.u8() != height:
            cur.fail(f"node height differs from its reference's {height}")
        files = _read_files(cur)
        n = cur.varint()
        keys, common = _read_keys(cur, n, height > 0)

        def file_of(i):
            if i >= len(files):
                cur.fail(f"data file {i} of {len(files)}")
            return files[i]

        if height == 0:
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k not in (0, 1) for k in kinds):
                cur.fail("unknown value kind")
            m = sum(kinds)
            fids, offsets = cur.varints(m), cur.varints(m)
            refs = iter(zip(fids, offsets))
            for key, size, kind in zip(keys, lengths, kinds):
                name = (prefix + key).decode()
                if kind:
                    fid, off = next(refs)
                    out[name] = self.slice(file_of(fid), off, size, name)
                    if self.locations is not None:
                        self.locations[name] = (file_of(fid), off, size)
                else:
                    out[name] = cur.take(size)
            cur.end()
            return n
        fids, offsets, lengths, counts = (cur.varints(n) for _ in range(4))
        cur.varints(2 * n)        # tree bytes, indirect value bytes
        cur.end()
        total = 0
        for i, key in enumerate(keys):
            child = prefix + key[:common[i]]
            got = self.node(file_of(fids[i]), offsets[i], lengths[i],
                            height - 1, child, out)
            if got != counts[i]:
                raise ValueError(f"{what}: child {i} holds {got} keys, "
                                 f"{counts[i]} expected")
            total += got
        return total


def _latest_root(buf, what: str):
    """(root height, file, offset, length, key count) of the newest
    version in a manifest, ``None`` for the empty tree."""
    cur = _Cursor(_unwrap(buf, MANIFEST_MAGIC, what), what)
    cur.take(16)
    if cur.varint() != 0:
        cur.fail("a numbered manifest (only the single-file kind is read)")
    cur.varints(2)
    cur.u8()
    if cur.varint() == 1:
        cur.fixed("<i")
    files = _read_files(cur)
    n = cur.varint()
    if n == 0:
        return None
    gens = cur.varints(n)
    heights = [cur.u8() for _ in range(n)]
    fids, offsets, lengths, counts = (cur.varints(n) for _ in range(4))
    last = max(range(n), key=gens.__getitem__)
    if lengths[last] == MISSING:
        return None
    if fids[last] >= len(files):
        cur.fail(f"root in data file {fids[last]} of {len(files)}")
    return (heights[last], files[fids[last]], offsets[last], lengths[last],
            counts[last])


def read_store(root: str, locations: Optional[dict] = None
               ) -> Dict[str, memoryview]:
    """Every key of the newest version of the store at ``root`` and its
    value (see the module docstring). ``locations``, where given, gets
    (data file relative to ``root``, offset, length) of every value kept
    in a data file."""
    manifest = os.path.join(root, "manifest.ocdbt")
    if not os.path.isfile(manifest):
        raise ValueError(f"{root}: no manifest.ocdbt")
    reader = _Reader(root, locations)
    with open(manifest, "rb") as f:
        latest = _latest_root(f.read(), manifest)
    out = {}
    if latest is not None:
        height, rel, offset, length, count = latest
        got = reader.node(rel, offset, length, height, b"", out)
        if got != count:
            raise ValueError(f"{manifest}: {got} keys found, {count} "
                             f"expected")
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(xs: Iterable[int]) -> bytes:
    return b"".join(_varint(x) for x in xs)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _wrap(body: bytes, magic: int) -> bytes:
    payload = bytes(zstd.compress(body, level=3))
    head = struct.pack(">I", magic)
    n = 4 + 8 + 2 + len(payload) + 4
    buf = head + struct.pack("<Q", n) + b"\x00\x01" + payload
    return buf + struct.pack("<I", crc32c(buf))


def _files_table(paths: List[Tuple[str, int]]) -> bytes:
    raw = [p.encode() for p, _ in paths]
    shared = [_shared(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    rest = [len(p) - (shared[i - 1] if i else 0) for i, p in enumerate(raw)]
    return (_varint(len(raw)) + _varints(shared) + _varints(rest)
            + _varints(b for _, b in paths)
            + b"".join(p[shared[i - 1] if i else 0:]
                       for i, p in enumerate(raw)))


def _keys(keys: List[bytes]) -> Tuple[bytes, bytes]:
    """(shared and remaining lengths, key bytes) of sorted keys."""
    shared = [_shared(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    rest = [k[shared[i - 1] if i else 0:] for i, k in enumerate(keys)]
    return (_varints(shared) + _varints(len(r) for r in rest),
            b"".join(rest))


def _leaf(entries, files: List[Tuple[str, int]]) -> bytes:
    """A leaf node of ``entries`` ((key without the node's prefix, inline
    bytes or (offset, length) in data file 0))."""
    lens, key_bytes = _keys([k for k, _ in entries])
    kinds = [int(isinstance(v, tuple)) for _, v in entries]
    sizes = [v[1] if isinstance(v, tuple) else len(v) for _, v in entries]
    offsets = [v[0] for _, v in entries if isinstance(v, tuple)]
    return (b"\x00" + _files_table(files if offsets else [])
            + _varint(len(entries)) + lens + key_bytes + _varints(sizes)
            + _varints(kinds) + _varints(0 for _ in offsets)
            + _varints(offsets)
            + b"".join(v for _, v in entries if not isinstance(v, tuple)))


def _interior(children, files: List[Tuple[str, int]]) -> bytes:
    """A height-1 node over ``children`` ((first key, common prefix
    length, offset, length, key count, tree bytes, indirect bytes) of
    leaves in data file 0)."""
    lens, key_bytes = _keys([c[0] for c in children])
    return (b"\x01" + _files_table(files) + _varint(len(children)) + lens
            + _varints(c[1] for c in children) + key_bytes
            + _varints(0 for _ in children)
            + b"".join(_varints(c[i] for c in children)
                       for i in range(2, 7)))


def _manifest(files: List[Tuple[str, int]], height: int, offset: int,
              length: int, count: int, tree_bytes: int,
              indirect: int) -> bytes:
    body = (os.urandom(16) + b"\x00" + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([VERSION_TREE_ARITY_LOG2]) + b"\x01"
            + struct.pack("<i", 0) + _files_table(files) + b"\x01"
            + b"\x01" + bytes([height]) + _varints(
                [0, offset, length, count, tree_bytes, indirect])
            + struct.pack("<Q", time.time_ns()) + b"\x00")
    return _wrap(body, MANIFEST_MAGIC)


def _hex() -> str:
    return os.urandom(16).hex()


def _write_tree(store: str, leaves: List[list],
                data: List[Tuple[str, int]]) -> tuple:
    """Write the nodes over ``leaves`` (lists of sorted (key, inline bytes
    or (offset, length) in ``data``)) into one file ``<store>/d/<hex>``;
    the manifest's (files, height, offset, length, key count, tree bytes,
    indirect value bytes)."""
    rel = f"d/{_hex()}"
    blob, refs = bytearray(), []
    for entries in leaves:
        common = (len(os.path.commonprefix([k for k, _ in entries]))
                  if len(leaves) > 1 else 0)
        node = _wrap(_leaf([(k[common:], v) for k, v in entries], data),
                     NODE_MAGIC)
        refs.append((entries[0][0], common, len(blob), len(node),
                     len(entries), len(node),
                     sum(v[1] for _, v in entries if isinstance(v, tuple))))
        blob += node
    count, indirect = sum(r[4] for r in refs), sum(r[6] for r in refs)
    if len(refs) == 1:
        root = (0, 0, len(blob))
    else:
        node = _wrap(_interior(refs, [(rel, 0)]), NODE_MAGIC)
        root = (1, len(blob), len(node))
        blob += node
    with open(os.path.join(store, rel), "wb") as f:
        f.write(blob)
    return [(rel, 0)], (*root, count, len(blob), indirect)


def _leaves(entries) -> List[list]:
    """``entries`` cut into leaves of at most ``MAX_DECODED_NODE_BYTES``
    decoded bytes (an upper estimate)."""
    leaves, size = [[]], 0
    for key, value in entries:
        cost = len(key) + 40 + (0 if isinstance(value, tuple)
                                else len(value))
        if leaves[-1] and size + cost > MAX_DECODED_NODE_BYTES:
            leaves.append([])
            size = 0
        leaves[-1].append((key, value))
        size += cost
    return leaves


def write_store(root: str, items: Iterable[Tuple[str, object]]
                ) -> Dict[str, int]:
    """Write ``items`` ((key, bytes-like value) in ascending key order,
    at least one, produced lazily: each value is written as it comes) as
    a new store at ``root`` (see the module docstring). Returns the bytes
    of values kept in the data file and of nodes and manifests."""
    proc = os.path.join(root, PROCESS)
    for d in (root, proc):
        os.makedirs(os.path.join(d, "d"), exist_ok=True)
    data_rel = f"d/{_hex()}"
    entries, prev, offset = [], None, 0
    with open(os.path.join(proc, data_rel), "wb") as data:
        for key, value in items:
            raw = key.encode()
            if prev is not None and raw <= prev:
                raise ValueError(f"keys out of order: {key!r} after "
                                 f"{prev.decode()!r}")
            prev = raw
            size = memoryview(value).nbytes
            if size > MAX_INLINE_VALUE_BYTES:
                data.write(value)
                entries.append((raw, (offset, size)))
                offset += size
            else:
                entries.append((raw, bytes(value)))
    if offset == 0:
        os.remove(os.path.join(proc, data_rel))
    if not entries:
        raise ValueError(f"{root}: no keys to write")
    leaves = _leaves(entries)
    nodes = 0
    # the process's own tree, then the root's: the same leaves, naming the
    # data file from each manifest's directory
    for store, base in ((proc, ""), (root, f"{PROCESS}/")):
        files, ref = _write_tree(store, leaves,
                                 [(f"{base}{data_rel}", len(base))])
        blob = _manifest(files, *ref)
        with open(os.path.join(store, "manifest.ocdbt"), "wb") as f:
            f.write(blob)
        nodes += ref[4] + len(blob)
    return {"values": offset, "nodes": nodes}
