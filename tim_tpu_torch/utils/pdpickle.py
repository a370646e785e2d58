"""pandas DataFrame pickles read without pandas or pyarrow:
``read_pickle(path) -> data.table.Table``.

The reference's annotation tables (EPIC-KITCHENS-100, EPIC-Sounds) and
the feature-time and video-info tables the extractors write are
``DataFrame.to_pickle`` files. Reading them takes two steps:

1. ``_Unpickler``, a ``pickle.Unpickler`` whose ``find_class`` resolves
   only a whitelist: numpy's array reconstructors (under both the
   ``numpy.core`` and ``numpy._core`` names), ``copyreg._reconstructor``
   (for this module's stubs only), ``builtins.slice``, ``object``,
   ``bytes`` and ``bytearray`` and latin-1 ``_codecs.encode`` (how
   protocols 2 to 4 write bytes), and every ``pandas.*`` and
   ``pyarrow.*`` name, which becomes an inert stub class of this module:
   calling it, or ``NEWOBJ`` and ``BUILD`` on it, records the arguments
   and the state and runs nothing. Any other global raises ``pickle.UnpicklingError`` naming
   ``module.name``.
2. ``_table`` walks the stub tree into a ``Table``. The layouts are
   pandas's own (``core/generic.py`` ``__getstate__``,
   ``core/internals/managers.py`` and ``_libs/internals.pyx``,
   ``core/indexes/{base,range}.py`` ``_new_Index``,
   ``core/arrays/string_.py``, ``core/arrays/arrow/array.py``,
   ``compat/pickle_compat.py``), as pandas 1.x to 3.x write them:

   - the frame's state under ``_mgr`` (``_data`` in older files), or the
     manager itself;
   - the manager as ``BlockManager(blocks, axes)`` with each block
     ``_unpickle_block(values, mgr_locs, ndim)`` (``new_block`` in pandas
     1.3), or as the ``"0.14.1"`` state whose blocks hold their values
     directly; ``mgr_locs`` a slice or an array;
   - numpy blocks of object, int, uint, float and bool (object columns
     may hold Python lists, as EPIC's ``all_nouns``);
   - ``Index`` (and pandas 1.x's ``Int64Index``, ``UInt64Index``,
     ``Float64Index``) and ``RangeIndex``, with their names;
   - string columns: the python-backed ``StringArray`` and
     ``ArrowStringArray`` over ``pyarrow.lib._restore_array`` of a
     ``string``/``large_string`` array (validity bitmap, int32 or int64
     offsets, UTF-8 bytes), decoded with numpy; pandas 3 writes its
     ``str`` columns so.

   Any other block or index (categorical, datetime, nullable integers,
   other pyarrow types, ``MultiIndex``) raises ``ValueError`` naming the
   column, or the index. A missing string becomes ``nan``.

Compression follows ``pd.read_pickle(compression="infer")``: ``.gz``,
``.bz2``, ``.xz`` and ``.zip`` through the standard library, ``.zst``
through ``utils.zstd`` (the system's libzstd).
"""

from __future__ import annotations

import _compat_pickle
import bz2
import gzip
import io
import lzma
import os
import pickle
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from tim_tpu_torch.data.table import Table


class _Record:
    """A pandas or pyarrow object as the pickle describes it: the stub's
    name (``module.name`` of the global), the arguments it was called or
    created with, and the state ``BUILD`` gave it."""

    pandas_name = "?"

    def __new__(cls, *args):
        self = object.__new__(cls)
        self.args = args
        self.state = None
        return self

    def __init__(self, *args):
        pass

    def __setstate__(self, state):
        self.state = state

    @property
    def name(self) -> str:
        return type(self).pandas_name

    def __repr__(self) -> str:
        return f"<{self.name}>"


def _reconstructor(cls, base, state):
    """``copyreg._reconstructor`` for this module's stubs only."""
    if not (isinstance(cls, type) and issubclass(cls, _Record)
            and base is object and state is None):
        raise pickle.UnpicklingError(
            f"read_pickle: copyreg._reconstructor of {cls!r} is not allowed")
    return cls.__new__(cls)


def _frombuffer(buf, dtype, shape, order, axis_order=None):
    """numpy's ``_frombuffer`` (protocol 5 arrays)."""
    array = np.frombuffer(buf, dtype=dtype)
    if order == "K" and axis_order is not None:
        return array.reshape(shape, order="C").transpose(axis_order)
    return array.reshape(shape, order=order)


def _latin1(text, encoding):
    """``_codecs.encode`` as protocol 2 writes bytes (latin-1 only)."""
    if encoding != "latin1":
        raise pickle.UnpicklingError(
            f"read_pickle: _codecs.encode to {encoding!r} is not allowed")
    return text.encode("latin1")


_NUMPY = {}
for _mod in ("numpy.core", "numpy._core"):
    _NUMPY.update({
        f"{_mod}.multiarray._reconstruct": np.empty(0).__reduce__()[0],
        f"{_mod}.multiarray.scalar": np.float64(0).__reduce__()[0],
        f"{_mod}.numeric._frombuffer": _frombuffer,
    })
_NUMPY.update({"numpy.dtype": np.dtype, "numpy.ndarray": np.ndarray})
_BUILTINS = {"copyreg._reconstructor": _reconstructor,
             "builtins.slice": slice, "builtins.object": object,
             # bytes as protocols 2-4 write them
             "builtins.bytes": bytes, "builtins.bytearray": bytearray,
             "_codecs.encode": _latin1}


class _Unpickler(pickle.Unpickler):
    """Resolves numpy's reconstructors, three builtins and inert stubs for
    pandas and pyarrow names; refuses every other global."""

    def __init__(self, file):
        super().__init__(file)
        self._stubs: Dict[str, type] = {}

    def find_class(self, module, name):
        # Python 2's names, as protocols 0-2 write them
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        key = f"{module}.{name}"
        if key in _NUMPY:
            return _NUMPY[key]
        if key in _BUILTINS:
            return _BUILTINS[key]
        if module.split(".")[0] in ("pandas", "pyarrow"):
            if key not in self._stubs:
                self._stubs[key] = type(name, (_Record,),
                                        {"pandas_name": key})
            return self._stubs[key]
        raise pickle.UnpicklingError(
            f"read_pickle: global {key} is not allowed in a DataFrame "
            f"pickle")


# ---------------------------------------------------------------------------
# the stub tree -> Table
# ---------------------------------------------------------------------------

def _is(obj, *suffixes) -> bool:
    """``obj`` is a stub (instance or class) of one of these names."""
    name = obj.pandas_name if isinstance(obj, type) and issubclass(
        obj, _Record) else getattr(obj, "name", None) if isinstance(
        obj, _Record) else None
    return name is not None and any(
        name == s or name.endswith("." + s) for s in suffixes)


def _kind(obj) -> str:
    if isinstance(obj, _Record):
        if _is(obj, "__pyx_unpickle_NDArrayBacked") and obj.args:
            return _kind(obj.args[0])
        return obj.name
    if isinstance(obj, type) and issubclass(obj, _Record):
        return obj.pandas_name
    if isinstance(obj, np.ndarray):
        return f"numpy {obj.dtype}"
    return type(obj).__name__


def _missing_to_nan(values: np.ndarray, where: str) -> np.ndarray:
    """An object column with pandas' missing markers (``None``, ``pd.NA``)
    as ``nan``; any other pandas object in it is refused."""
    out = np.empty(len(values), object)
    for i, v in enumerate(values):
        if v is None or _is(v, "NA"):
            v = np.nan
        elif isinstance(v, _Record) or (isinstance(v, type)
                                        and issubclass(v, _Record)):
            raise ValueError(f"{where}: a value of kind {_kind(v)}")
        out[i] = v
    return out


def _buffer(buf) -> bytes:
    if buf is None:
        return b""
    if _is(buf, "py_buffer") and buf.args:
        return bytes(buf.args[0])
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return bytes(buf)
    raise ValueError(f"an arrow buffer of kind {_kind(buf)}")


def _arrow_strings(arr, where: str) -> np.ndarray:
    """A pyarrow ``string``/``large_string`` array (``_restore_array`` or
    ``chunked_array`` of them) as an object array of str, nulls nan."""
    if _is(arr, "chunked_array"):
        chunks = list(arr.args[0]) if arr.args else []
        parts = [_arrow_strings(c, where) for c in chunks]
        return np.concatenate(parts) if parts else np.zeros(0, object)
    if not (_is(arr, "_restore_array") and arr.args):
        raise ValueError(f"{where}: an arrow array of kind {_kind(arr)} is "
                         f"not supported")
    typ, length, null_count, offset, buffers = arr.args[0][:5]
    alias = typ.args[0] if _is(typ, "type_for_alias") and typ.args else \
        _kind(typ)
    widths = {"string": np.int32, "utf8": np.int32,
              "large_string": np.int64, "large_utf8": np.int64}
    if alias not in widths:
        raise ValueError(f"{where}: pyarrow type {alias!r} is not supported "
                         f"(strings only)")
    validity, offsets, data = (list(buffers) + [None] * 3)[:3]
    off = np.frombuffer(_buffer(offsets), widths[alias])[
        offset:offset + length + 1]
    raw = _buffer(data)
    if validity is not None and null_count != 0:
        valid = np.unpackbits(np.frombuffer(_buffer(validity), np.uint8),
                              bitorder="little")[offset:offset + length]
    else:
        valid = np.ones(length, np.uint8)
    out = np.empty(length, object)
    for i in range(length):
        out[i] = raw[off[i]:off[i + 1]].decode("utf-8") if valid[i] \
            else np.nan
    return out


def _state_items(rec) -> dict:
    """A stub's state as a dict (``__dict__`` states) or {}."""
    if isinstance(rec.state, dict):
        return rec.state
    if isinstance(rec.state, tuple) and rec.state and isinstance(
            rec.state[-1], dict):
        return rec.state[-1]
    return {}


def _columns_of(values, n: int, where: str) -> List[np.ndarray]:
    """A block's (or an index's) values as ``n`` 1-D columns."""
    if isinstance(values, np.ndarray):
        if values.dtype.kind not in "iufbO":
            raise ValueError(f"{where}: numpy dtype {values.dtype} is not "
                             f"supported")
        if values.ndim == 1:
            cols = [values]
        elif values.ndim == 2:
            cols = list(values)
        else:
            raise ValueError(f"{where}: a block of shape {values.shape}")
        if len(cols) != n:
            raise ValueError(f"{where}: {len(cols)} columns in a block of "
                             f"{n}")
        return [np.ascontiguousarray(c) if c.dtype != object
                else _missing_to_nan(c, where) for c in cols]
    kind = _kind(values)
    if n == 1 and kind.endswith("ArrowStringArray"):
        st = _state_items(values)
        pa = st.get("_pa_array", st.get("_data"))
        return [_arrow_strings(pa, where)]
    if n == 1 and kind.endswith(".StringArray"):
        # NDArrayBacked's state: (ndarray, dtype[, dict]) or a __dict__
        state = values.state
        if state is None and len(values.args) > 2:
            state = values.args[2]
        arrays = [s for s in (state if isinstance(state, tuple) else
                              [state.get("_ndarray")]
                              if isinstance(state, dict) else [])
                  if isinstance(s, np.ndarray)]
        if len(arrays) == 1 and arrays[0].ndim == 1 and \
                arrays[0].dtype == object:
            return _columns_of(arrays[0], 1, where)
    raise ValueError(f"{where}: {kind} is not supported (numbers, bools, "
                     f"objects and strings only)")


def _index(obj, where: str) -> Tuple[np.ndarray, object]:
    """An axis as (values, name)."""
    if not (_is(obj, "_new_Index") and len(obj.args) == 2):
        raise ValueError(f"{where}: an index of kind {_kind(obj)} is not "
                         f"supported")
    cls, d = obj.args
    kind = _kind(cls)
    if _is(cls, "RangeIndex"):
        return (np.arange(d.get("start", 0), d["stop"], d.get("step", 1),
                          dtype=np.int64), d.get("name"))
    if _is(cls, "Index", "Int64Index", "UInt64Index", "Float64Index",
           "NumericIndex"):
        (values,) = _columns_of(d["data"], 1, where)
        return values, d.get("name")
    raise ValueError(f"{where}: {kind} is not supported (Index and "
                     f"RangeIndex only)")


def _blocks(mgr) -> Tuple[list, List[Tuple[object, object]]]:
    """A manager's (axes, [(values, mgr_locs)])."""
    if not _is(mgr, "BlockManager"):
        raise ValueError(f"the frame's data is a {_kind(mgr)}, not a "
                         f"BlockManager")
    if len(mgr.args) >= 2:
        blocks, axes = mgr.args[:2]
        out = []
        for b in blocks:
            if not (_is(b, "_unpickle_block", "new_block")
                    and len(b.args) >= 2):
                raise ValueError(f"a block of kind {_kind(b)}")
            out.append((b.args[0], b.args[1]))
        return list(axes), out
    state = mgr.state
    if isinstance(state, tuple) and len(state) >= 4 and isinstance(
            state[3], dict) and "0.14.1" in state[3]:
        st = state[3]["0.14.1"]
        return list(st["axes"]), [(b["values"], b["mgr_locs"])
                                  for b in st["blocks"]]
    raise ValueError("a BlockManager state older than pandas 0.14.1")


def _table(obj) -> Table:
    if not _is(obj, "DataFrame"):
        raise ValueError(f"the pickle holds a {_kind(obj)}, not a "
                         f"DataFrame")
    state = obj.state
    mgr = state.get("_mgr", state.get("_data")) if isinstance(
        state, dict) else state
    axes, blocks = _blocks(mgr)
    if len(axes) != 2:
        raise ValueError(f"a frame of {len(axes)} axes")
    names, _ = _index(axes[0], "the column labels")
    names = list(names)
    if not all(isinstance(k, str) for k in names) or len(set(names)) != len(
            names):
        raise ValueError(f"column labels {names}: distinct strings only")
    index, index_name = _index(axes[1], "the index")
    cols: List[object] = [None] * len(names)
    positions = np.arange(len(names))
    for values, locs in blocks:
        at = positions[locs] if isinstance(locs, slice) else \
            np.asarray(locs, np.int64).reshape(-1)
        where = "column " + ", ".join(repr(names[i]) for i in at)
        for i, col in zip(at, _columns_of(values, len(at), where)):
            cols[i] = col
    missing = [names[i] for i, c in enumerate(cols) if c is None]
    if missing:
        raise ValueError(f"no block holds columns {missing}")
    return Table(dict(zip(names, cols)), index=index, index_name=index_name)


def _read_bytes(path) -> bytes:
    """The file's bytes, decompressed by its extension."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        raw = f.read()
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gz":
        return gzip.decompress(raw)
    if ext == ".bz2":
        return bz2.decompress(raw)
    if ext == ".xz":
        return lzma.decompress(raw)
    if ext == ".zip":
        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            members = z.namelist()
            if len(members) != 1:
                raise ValueError(f"{path}: a zip of {len(members)} files, "
                                 f"one expected")
            return z.read(members[0])
    if ext == ".zst":
        from tim_tpu_torch.utils import zstd
        return bytes(zstd.decompress(raw))
    return raw


def read_pickle(path) -> Table:
    """The DataFrame pickled at ``path`` as a ``Table`` (see the module's
    docstring for the layouts read and refused)."""
    obj = _Unpickler(io.BytesIO(_read_bytes(path))).load()
    try:
        return _table(obj)
    except ValueError as e:
        raise ValueError(f"{os.fspath(path)}: {e}") from None

