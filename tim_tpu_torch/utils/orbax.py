"""Orbax checkpoint directories (orbax-checkpoint's ``StandardCheckpointer``
over OCDBT and zarr v2, as ``tim_tpu/train/checkpoint.py``'s
``save_checkpoint_orbax`` writes them) read and written with torch, numpy
and libzstd only.

A step directory holds:

- ``_METADATA`` (JSON): ``tree_metadata`` maps each tree path (the
  ``str`` of its key tuple) to ``key_metadata`` (each key and its type:
  2 a dict key, 1 a list index) and ``value_metadata``: ``value_type``
  ``jax.Array`` (with its ``write_shape``), ``np.ndarray`` or ``scalar``
  (a Python number) for a stored value; ``Dict``, ``List`` or ``None``
  (``skip_deserialize``) for an empty dict (optax's ``EmptyState``), an
  empty list or ``None``;
- ``_CHECKPOINT_METADATA``, ``_sharding`` (base64 of each ``jax.Array``'s
  name -> its sharding) and ``array_metadatas/process_<i>`` (each
  ``jax.Array``'s write and chunk shape), JSON;
- an OCDBT store (``utils.ocdbt``) whose keys are zarr v2 keys under each
  value's name (its tree path joined by ``.``): ``<name>/.zarray``
  (shape, chunks, dtype ``<f4`` ``<f8`` ``<f2`` ``bfloat16`` ``<i8``
  ``<i4`` ``<i2`` ``|i1`` ``|u1`` ``|b1``, order, fill value, the zstd
  compressor) and one value per chunk, ``<name>/<i>.<j>...`` (``0`` for
  a 0-d array): a zstd frame of the chunk's bytes.

``read_tree(dir)`` rebuilds the tree: array leaves (``jax.Array`` and
``np.ndarray``) as CPU tensors (``bfloat16`` as ``torch.bfloat16``),
``scalar`` leaves as Python numbers, empty nodes as ``{}``, ``[]`` or
``None``. Each array is allocated once and its chunks are decoded
straight into it (a chunk that covers the whole array in C order) or
through one chunk-sized buffer (edge chunks, stored at full size, are
cropped; a missing chunk takes the fill value, 0 for ``null``; Fortran
order is transposed), several arrays at a time on threads (ctypes
releases the GIL). A bad value raises ``ValueError`` naming its key.

``write_tree(dir, tree)`` writes the directory a one-process CPU save of
the same tree writes: tensor leaves as ``jax.Array`` (one chunk, the
whole array), numpy arrays and scalars as ``np.ndarray``, Python
numbers as ``scalar``, empty dicts and lists and ``None`` as such, every
JSON file above with orbax's fields; chunks are compressed on threads
and streamed to the store's data file in key order. Orbax refuses
strings and arrays with no elements, and so does this writer.
"""

from __future__ import annotations

import base64
import collections
import itertools
import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Tuple

import numpy as np
import torch

from tim_tpu_torch.utils import ocdbt, zstd

METADATA, CHECKPOINT_METADATA, SHARDING = (
    "_METADATA", "_CHECKPOINT_METADATA", "_sharding")
ARRAY_METADATAS = "array_metadatas"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
SINGLE_DEVICE = json.dumps({"sharding_type": "SingleDeviceSharding",
                            "device_str": "TFRT_CPU_0"})
KEY_SEQUENCE, KEY_DICT = 1, 2
EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
ZLEVEL = 1

# zarr v2 dtype -> torch dtype, and back as orbax writes it
DTYPES = {"|b1": torch.bool, "|i1": torch.int8, "|u1": torch.uint8,
          "<i2": torch.int16, "<i4": torch.int32, "<i8": torch.int64,
          "<f2": torch.float16, "bfloat16": torch.bfloat16,
          "<f4": torch.float32, "<f8": torch.float64}
ZARR_NAMES = {v: k for k, v in DTYPES.items()}


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

class ZArray(NamedTuple):
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: torch.dtype
    order: str
    fill: Any


def parse_zarray(raw, name: str) -> ZArray:
    """The fields of a ``.zarray`` that a chunk read needs."""
    try:
        meta = json.loads(bytes(raw))
    except ValueError as e:
        raise ValueError(f"{name}/.zarray: {e}") from None

    def bad(what):
        raise ValueError(f"{name}/.zarray: {what}")

    if meta.get("zarr_format") != 2:
        bad(f"zarr_format {meta.get('zarr_format')!r}")
    if meta.get("dtype") not in DTYPES:
        bad(f"dtype {meta.get('dtype')!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        bad(f"chunks {list(chunks)} for shape {list(shape)}")
    if meta.get("order", "C") not in ("C", "F"):
        bad(f"order {meta.get('order')!r}")
    if meta.get("filters"):
        bad(f"filters {meta['filters']!r}")
    if (meta.get("compressor") or {}).get("id") != "zstd":
        bad(f"compressor {meta.get('compressor')!r}")
    if meta.get("dimension_separator", ".") != ".":
        bad(f"dimension_separator {meta['dimension_separator']!r}")
    fill = meta.get("fill_value")
    fill = {"NaN": math.nan, "Infinity": math.inf,
            "-Infinity": -math.inf}.get(fill, fill) if fill is not None \
        else 0
    return ZArray(shape, chunks, DTYPES[meta["dtype"]], meta.get("order", "C"),
                  fill)


def _decode(raw, out: torch.Tensor, key: str) -> None:
    """One chunk's zstd frame into ``out`` (contiguous, the chunk's
    bytes)."""
    try:
        zstd.decompress(raw, out)
    except ValueError as e:
        raise ValueError(f"{key}: {e}") from None


def read_array(values: Dict[str, Any], name: str) -> torch.Tensor:
    """The array ``name`` of an OCDBT store's ``values``."""
    meta = values.get(f"{name}/.zarray")
    if meta is None:
        raise ValueError(f"{name}/.zarray: missing")
    za = parse_zarray(meta, name)
    out = torch.empty(za.shape, dtype=za.dtype)
    grid = [-(-s // c) for s, c in zip(za.shape, za.chunks)]
    whole = za.chunks == za.shape and (
        za.order == "C" or sum(d > 1 for d in za.shape) <= 1)
    scratch = None
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/" + (".".join(map(str, idx)) or "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, za.chunks, za.shape))
        raw = values.get(key)
        if raw is None:
            out[region] = za.fill
        elif whole:
            _decode(raw, out, key)
        else:
            if scratch is None:
                scratch = torch.empty(math.prod(za.chunks), dtype=za.dtype)
            _decode(raw, scratch, key)
            chunk = (scratch.view(za.chunks) if za.order == "C" else
                     scratch.view(za.chunks[::-1]).permute(
                         *reversed(range(len(za.chunks)))))
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    return out


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

class _Seq(dict):
    """A list under construction: its items by index."""


def _insert(tree: dict, keys: List[Tuple[Any, int]], value) -> None:
    node = tree
    for i, (key, kind) in enumerate(keys):
        k = int(key) if kind == KEY_SEQUENCE else key
        if i == len(keys) - 1:
            node[k] = value
        else:
            node = node.setdefault(
                k, _Seq() if keys[i + 1][1] == KEY_SEQUENCE else {})


def _finish(node):
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} have gaps")
        return [_finish(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path}: {e}") from None


def read_tree(step_dir: str) -> Dict[str, Any]:
    """The tree saved in the orbax step directory ``step_dir``."""
    meta = _load_json(os.path.join(step_dir, METADATA))
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{step_dir}: only OCDBT + zarr v2 checkpoints "
                         f"are read")
    values = ocdbt.read_store(step_dir)
    leaves, arrays = [], []
    for path, entry in meta["tree_metadata"].items():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind in EMPTY:
            leaves.append((keys, EMPTY[kind]()))
        elif kind in ("jax.Array", "np.ndarray", "scalar"):
            name = ".".join(str(k) for k, _ in keys)
            leaves.append((keys, (kind, len(arrays))))
            arrays.append(name)
        else:
            raise ValueError(f"{step_dir}: {path} has value type {kind!r}")
    with ThreadPoolExecutor(_workers()) as pool:
        got = list(pool.map(lambda n: read_array(values, n), arrays))
    tree: Dict[str, Any] = {}
    for keys, leaf in leaves:
        if isinstance(leaf, tuple):
            kind, i = leaf
            leaf = got[i].item() if kind == "scalar" else got[i]
        _insert(tree, keys, leaf)
    return _finish(tree)


def _flatten(tree, keys=()) -> List[Tuple[tuple, Any]]:
    """(keys ((key, type), ...), leaf) in JAX's flatten order: dict keys
    sorted, lists in order; an empty dict or list is a leaf."""
    if isinstance(tree, dict) and tree:
        return [x for k in sorted(tree) for x in
                _flatten(tree[k], keys + ((str(k), KEY_DICT),))]
    if isinstance(tree, (list, tuple)) and tree:
        if isinstance(tree, tuple):
            raise TypeError(f"{_path(keys)}: a tuple (orbax restores "
                            f"lists)")
        return [x for i, v in enumerate(tree) for x in
                _flatten(v, keys + ((str(i), KEY_SEQUENCE),))]
    return [(keys, tree)]


def _path(keys) -> str:
    return str(tuple(k for k, _ in keys))


def _classify(keys, leaf) -> Tuple[str, Any]:
    """(value type, the value as a CPU tensor or an empty node)."""
    if isinstance(leaf, torch.Tensor):
        kind, t = "jax.Array", leaf.detach().cpu()
    elif isinstance(leaf, (np.ndarray, np.generic)):
        kind, t = "np.ndarray", torch.from_numpy(np.array(leaf))
    elif isinstance(leaf, (bool, int, float)):
        kind = "scalar"
        t = torch.tensor(leaf, dtype=torch.bool if isinstance(leaf, bool)
                         else torch.int64 if isinstance(leaf, int)
                         else torch.float64)
    elif leaf is None or leaf == {} or leaf == []:
        return {dict: "Dict", list: "List"}.get(type(leaf), "None"), None
    else:
        raise TypeError(f"{_path(keys)}: orbax stores no "
                        f"{type(leaf).__name__} leaf")
    if t.dtype not in ZARR_NAMES:
        raise TypeError(f"{_path(keys)}: dtype {t.dtype} has no zarr name")
    if t.numel() == 0:
        raise ValueError(f"{_path(keys)}: orbax saves no array with zero "
                         f"elements")
    return kind, t


def _zarray(t: torch.Tensor) -> bytes:
    return json.dumps({
        "chunks": list(t.shape), "compressor": {"id": "zstd",
                                                "level": ZLEVEL},
        "dimension_separator": ".", "dtype": ZARR_NAMES[t.dtype],
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(t.shape), "zarr_format": 2},
        sort_keys=True, separators=(",", ":")).encode()


def _ordered(fns: Iterable[Tuple[str, Callable[[], Any]]], workers: int
             ) -> Iterable[Tuple[str, Any]]:
    """(key, fn()) in order, at most ``2 * workers`` computed ahead."""
    with ThreadPoolExecutor(workers) as pool:
        pending = collections.deque()
        for key, fn in fns:
            pending.append((key, pool.submit(fn)))
            if len(pending) >= 2 * workers:
                k, fut = pending.popleft()
                yield k, fut.result()
        while pending:
            k, fut = pending.popleft()
            yield k, fut.result()


def write_tree(step_dir: str, tree: Dict[str, Any]) -> Dict[str, int]:
    """Write ``tree`` as the orbax step directory ``step_dir`` (a new
    directory); returns the bytes written (``values`` in the data file,
    ``nodes`` of the OCDBT trees, ``total`` of every file)."""
    start = time.time_ns()
    flat = [(keys, *_classify(keys, leaf)) for keys, leaf in _flatten(tree)]
    os.makedirs(step_dir)
    metadata, arrays = {}, []
    for keys, kind, t in flat:
        value = {"value_type": kind, "skip_deserialize": t is None}
        if kind == "jax.Array":
            value["write_shape"] = list(t.shape)
        metadata[_path(keys)] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in keys],
            "value_metadata": value}
        if t is not None:
            arrays.append((".".join(k for k, _ in keys), kind, t))
    items = []
    for name, _, t in arrays:
        chunk = f"{name}/" + (".".join("0" * t.dim()) or "0")
        items.append((f"{name}/.zarray", lambda t=t: _zarray(t)))
        items.append((chunk, lambda t=t: zstd.compress(t.contiguous(),
                                                       ZLEVEL)))
    items.sort(key=lambda kv: kv[0].encode())
    sizes = ocdbt.write_store(step_dir, _ordered(items, _workers()))
    jax_arrays = sorted((n, t) for n, k, t in arrays if k == "jax.Array")
    files = {
        METADATA: {"tree_metadata": metadata, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None},
        SHARDING: {base64.b64encode(n.encode()).decode(): SINGLE_DEVICE
                   for n, _ in jax_arrays},
        os.path.join(ARRAY_METADATAS, "process_0"): {"array_metadatas": [
            {"array_metadata": {"param_name": n, "write_shape": list(t.shape),
                                "chunk_shape": list(t.shape),
                                "ext_metadata": None}}
            for n, t in jax_arrays]},
    }
    os.makedirs(os.path.join(step_dir, ARRAY_METADATAS))
    for name, obj in files.items():
        with open(os.path.join(step_dir, name), "w") as f:
            f.write(json.dumps(obj, separators=(",", ":"))
                    if name == SHARDING else json.dumps(obj))
    with open(os.path.join(step_dir, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": start,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(step_dir) for f in fs)
    return {**sizes, "total": total}
