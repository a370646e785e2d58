"""A column table of the port's own: what the port does with the
reference's annotation and feature-time tables, without pandas.

``Table`` holds ordered columns, each a 1-D numpy array (``object`` for
strings and for Python lists such as EPIC's ``all_nouns``; a missing
string is ``nan``), and an index: an array and its name. It has only the
operations the port uses, each with the semantics of the pandas call it
replaces:

- ``t[name]`` (the column's array), ``t[name] = values``, ``columns``,
  ``len(t)``, ``name in t``;
- ``where(mask)`` and ``take(positions)`` (``df[mask]``, ``df.iloc[...]``:
  the index goes with the rows);
- ``select(names)``, ``drop(names)``, ``reset_index(drop=...)``,
  ``concat(tables)``;
- ``unique(name)`` in order of first appearance;
- ``sort_by(name)``: ``np.argsort(kind="quicksort")`` with NaN last, the
  call ``sort_values`` makes for one column, so that ties order alike;
- ``groups(name)``: the sorted keys, each with its rows in table order
  (``groupby(name).get_group``);
- ``rows()`` (``iterrows``), ``to_numpy(dtype)`` over the columns in
  order;
- ``Table.from_records(dicts)`` (``pd.DataFrame(dicts)``);
- ``Table.from_frame(obj)`` from anything with ``.columns``, ``.index``
  and per-column ``.to_numpy`` (a DataFrame), importing nothing.

``read_csv(path)`` reads a CSV with ``pd.read_csv``'s defaults for the
EPIC schemas: the header's columns in order, int64 where every value is
an integer, float64 where a value is empty (NaN) or decimal, ``object``
(strings) otherwise; quoted fields (``"['tap', 'water']"``) stay strings;
a ``RangeIndex``. ``utils.pdpickle.read_pickle`` reads the reference's
DataFrame pickles into a ``Table``.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _is_nan(value) -> bool:
    return isinstance(value, (float, np.floating)) and math.isnan(value)


def as_column(values, n: Optional[int] = None) -> np.ndarray:
    """``values`` as a 1-D column: a scalar repeated ``n`` times (int64,
    float64, bool or object), a numpy array as it is (strings as
    ``object``), a sequence as numpy infers it, except that strings,
    lists and ``None`` make an ``object`` column element by element."""
    if isinstance(values, np.ndarray):
        if values.ndim != 1:
            raise ValueError(f"a column is 1-D, got shape {values.shape}")
        if values.dtype.kind in "US":
            values = values.astype(object)
        return values
    if isinstance(values, (str, bytes, int, float, bool, np.generic)) \
            or values is None:
        if n is None:
            raise ValueError("a scalar column needs a length")
        if isinstance(values, (str, bytes)) or values is None:
            out = np.empty(n, object)
            out[:] = [values] * n
            return out
        return np.full(n, values)
    values = list(values)
    if not values or any(
            isinstance(v, (str, bytes, list, tuple, dict, set)) or v is None
            for v in values):
        out = np.empty(len(values), object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return as_column(np.asarray(values))


def isin(values: np.ndarray, candidates: Iterable) -> np.ndarray:
    """``values``' elements that are among ``candidates`` (``Index.isin``),
    by hashing, so that object arrays need no ordering."""
    wanted = set(candidates)
    return np.fromiter((v in wanted for v in values), bool, len(values))


def _common_dtype(dtypes: Sequence[np.dtype]) -> np.dtype:
    """The dtype ``pd.concat`` gives columns of these dtypes: the same
    dtype, the promotion of numbers (int64 and float64 -> float64), object
    for anything else (bool with numbers, strings)."""
    first = dtypes[0]
    if all(d == first for d in dtypes):
        return first
    if all(d.kind in "iuf" for d in dtypes):
        return np.result_type(*dtypes)
    return np.dtype(object)


def _missing(dtype: np.dtype, n: int) -> np.ndarray:
    """NaN rows for a column a concatenated table lacks."""
    if dtype.kind in "iuf":
        return np.full(n, np.nan)
    out = np.empty(n, object)
    out[:] = np.nan
    return out


class Table:
    """Ordered named 1-D columns of one length and an index (an array and
    its name; ``np.arange(n)`` named None when not given)."""

    def __init__(self, columns: Optional[Dict[str, object]] = None, *,
                 index=None, index_name: Optional[str] = None):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in (columns or {}).items():
            col = as_column(values, n)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(f"column {name!r} has {len(col)} rows, "
                                 f"the table {n}")
            self._cols[str(name)] = col
        if index is None:
            index = np.arange(n or 0)
        index = as_column(index, n)
        if n is not None and len(index) != n:
            raise ValueError(f"the index has {len(index)} rows, the table "
                             f"{n}")
        self.index = index
        self.index_name = index_name

    # -- columns ------------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        if not isinstance(name, str):
            raise TypeError(f"Table[{name!r}]: a column name; rows are "
                            f"selected with where() and take()")
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(f"no column {name!r} (columns: "
                           f"{self.columns})") from None

    def __setitem__(self, name: str, values) -> None:
        col = as_column(values, len(self))
        if len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = col

    def __repr__(self) -> str:
        return (f"Table({len(self)} rows, index {self.index_name!r}, "
                f"columns {self.columns})")

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()},
                     index=self.index.copy(), index_name=self.index_name)

    # -- rows ---------------------------------------------------------------

    def take(self, positions) -> "Table":
        """The rows at ``positions`` (``iloc``), their index with them."""
        positions = np.asarray(positions, np.int64)
        return Table({k: v[positions] for k, v in self._cols.items()},
                     index=self.index[positions], index_name=self.index_name)

    def where(self, mask) -> "Table":
        """The rows where ``mask`` is true (``df[mask]``)."""
        mask = np.asarray(mask, bool)
        if mask.shape != (len(self),):
            raise ValueError(f"a mask of {mask.shape} for {len(self)} rows")
        return self.take(np.flatnonzero(mask))

    def rows(self) -> Iterator[Tuple[object, Dict[str, object]]]:
        """(index label, {column: value}) per row (``iterrows``)."""
        names = self.columns
        cols = [self._cols[k] for k in names]
        for i, label in enumerate(self.index):
            yield label, {k: c[i] for k, c in zip(names, cols)}

    # -- shape --------------------------------------------------------------

    def select(self, names: Sequence[str]) -> "Table":
        """These columns, in this order (``df[[...]]``)."""
        return Table({k: self[k] for k in names}, index=self.index,
                     index_name=self.index_name)

    def drop(self, names: Iterable[str]) -> "Table":
        """Every column but these (``drop(columns=...)``; each must exist)."""
        names = list(names)
        for k in names:
            self[k]
        return Table({k: v for k, v in self._cols.items() if k not in names},
                     index=self.index, index_name=self.index_name)

    def reset_index(self, drop: bool = False) -> "Table":
        """A ``RangeIndex``; unless ``drop``, the old index becomes the
        first column, named after it (``"index"`` when it has no name)."""
        cols = dict(self._cols)
        if not drop:
            name = self.index_name if self.index_name is not None else "index"
            if name in cols:
                raise ValueError(f"reset_index: column {name!r} exists")
            cols = {name: self.index, **cols}
        return Table(cols, index=np.arange(len(self)))

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Rows of ``tables`` one after another (``pd.concat(axis=0)``):
        columns in order of first appearance, a column missing from a
        table filled with NaN, dtypes promoted as pandas does, the
        indexes concatenated."""
        tables = list(tables)
        names: List[str] = []
        for t in tables:
            names += [k for k in t.columns if k not in names]
        cols = {}
        for k in names:
            present = [t[k].dtype for t in tables if k in t]
            if len(present) < len(tables):
                present.append(np.dtype(np.float64) if all(
                    d.kind in "iuf" for d in present) else np.dtype(object))
            dtype = _common_dtype(present)
            cols[k] = np.concatenate([
                (t[k] if k in t else _missing(dtype, len(t))).astype(dtype)
                for t in tables])
        names_of_index = {t.index_name for t in tables}
        index_dtype = _common_dtype([t.index.dtype for t in tables])
        index = np.concatenate([t.index.astype(index_dtype) for t in tables])
        return Table(cols, index=index,
                     index_name=names_of_index.pop()
                     if len(names_of_index) == 1 else None)

    # -- order --------------------------------------------------------------

    def unique(self, name: str) -> np.ndarray:
        """The column's distinct values in order of first appearance, NaN
        once (``Series.unique``)."""
        values = self[name]
        seen, first, nan = set(), [], False
        for i, v in enumerate(values.tolist()):
            if _is_nan(v):
                if not nan:
                    nan = True
                    first.append(i)
            elif v not in seen:
                seen.add(v)
                first.append(i)
        return values[np.asarray(first, np.int64)]

    def sort_by(self, name: str) -> "Table":
        """Rows in ascending order of one column: ``np.argsort`` with
        ``kind="quicksort"`` over the values that are not NaN, NaN rows
        last, the call ``sort_values`` makes (pandas' ``nargsort``), so
        that ties come out in the same order."""
        values = self[name]
        if values.dtype.kind == "f":
            nan = np.isnan(values)
        elif values.dtype == object:
            nan = np.fromiter((_is_nan(v) or v is None for v in values),
                              bool, len(values))
        else:
            nan = np.zeros(len(values), bool)
        rows = np.arange(len(values))
        order = rows[~nan][values[~nan].argsort(kind="quicksort")]
        return self.take(np.concatenate([order, rows[nan]]))

    def groups(self, name: str) -> Dict[object, "Table"]:
        """{key: the key's rows in table order}, keys sorted
        (``groupby(name).get_group(key)``; NaN keys dropped as there)."""
        positions: Dict[object, List[int]] = {}
        for i, v in enumerate(self[name].tolist()):
            if v is not None and not _is_nan(v):
                positions.setdefault(v, []).append(i)
        return {key: self.take(positions[key]) for key in sorted(positions)}

    # -- out ----------------------------------------------------------------

    def to_numpy(self, dtype=None) -> np.ndarray:
        """[rows, columns] in column order. With ``dtype`` each column is
        cast to it directly (``DataFrame.to_numpy(dtype)``); without, to
        the columns' common dtype."""
        cols = list(self._cols.values())
        if not cols:
            return np.zeros((len(self), 0), dtype or np.float64)
        if dtype is None:
            dtype = _common_dtype([c.dtype for c in cols])
        out = np.empty((len(self), len(cols)), dtype)
        for j, c in enumerate(cols):
            out[:, j] = c
        return out

    @classmethod
    def from_records(cls, records: Sequence[Dict[str, object]], *,
                     index=None, index_name: Optional[str] = None
                     ) -> "Table":
        """One row a dict (``pd.DataFrame(records)``): columns in order of
        first appearance, NaN where a record lacks one."""
        names: List[str] = []
        for r in records:
            names += [k for k in r if k not in names]
        return cls({k: [r.get(k, np.nan) for r in records] for k in names},
                   index=index, index_name=index_name)

    @classmethod
    def from_frame(cls, frame) -> "Table":
        """A ``Table`` of anything with ``.columns``, ``.index`` (with
        ``.name`` and ``.to_numpy()``) and per-column ``.to_numpy()``: a
        pandas DataFrame, without importing pandas. pandas' missing
        markers in object columns (``None``, ``pd.NA``) become NaN."""
        def values(series) -> np.ndarray:
            arr = np.asarray(series.to_numpy())
            if arr.dtype == object:
                arr = arr.copy()
                for i, v in enumerate(arr):
                    if v is None or type(v).__name__ == "NAType":
                        arr[i] = np.nan
            return arr

        return cls({str(k): values(frame[k]) for k in frame.columns},
                   index=values(frame.index),
                   index_name=frame.index.name)

    def equals(self, other: "Table") -> bool:
        """Same columns in the same order, dtypes and index; numbers equal
        bit for bit, objects of the same type and equal, NaN in the same
        places."""
        def same(a, b):
            if a.dtype != b.dtype or a.shape != b.shape:
                return False
            if a.dtype == object:
                return all(_same_object(x, y) for x, y in zip(a, b))
            return a.tobytes() == b.tobytes()
        return (self.columns == other.columns
                and self.index_name == other.index_name
                and same(self.index, other.index)
                and all(same(self[k], other[k]) for k in self.columns))


def _same_object(x, y) -> bool:
    if _is_nan(x) and _is_nan(y):
        return True
    return type(x) is type(y) and bool(x == y)


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

# pd.read_csv's default missing-value strings
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Inf|INF"
    r"|infinity|Infinity)\Z")


def _infer(name: str, cells: List[str]) -> np.ndarray:
    """One CSV column as ``pd.read_csv`` types it: int64 when every cell
    is an integer, float64 when every cell is a number or missing,
    ``object`` (strings, missing as NaN) otherwise."""
    missing = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if present and not any(missing) and all(_INT.match(c) for c in present):
        values = [int(c) for c in present]
        if all(-2 ** 63 <= v < 2 ** 63 for v in values):
            return np.asarray(values, np.int64)
        if all(0 <= v < 2 ** 64 for v in values):
            return np.asarray(values, np.uint64)
    if all(_INT.match(c) or _FLOAT.match(c) for c in present) and (
            present or cells):
        return np.asarray([np.nan if m else float(c)
                           for c, m in zip(cells, missing)], np.float64)
    out = np.empty(len(cells), object)
    out[:] = [np.nan if m else c for c, m in zip(cells, missing)]
    return out


def read_csv(path) -> Table:
    """A CSV file with a header row as ``pd.read_csv(path)`` reads the
    EPIC annotation files (comma separated, ``"`` quoting, blank lines
    skipped, an unnamed header cell named ``Unnamed: i``)."""
    with open(path, newline="", encoding="utf-8") as f:
        records = [r for r in csv.reader(f) if r]
    if not records:
        raise ValueError(f"{path}: no header row")
    header = [h if h else f"Unnamed: {i}" for i, h in enumerate(records[0])]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: repeated column names {header}")
    body = records[1:]
    for line, r in enumerate(body, start=2):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {line} has {len(r)} fields, the "
                             f"header {len(header)}")
    body = [r + [""] * (len(header) - len(r)) for r in body]
    return Table({name: _infer(name, [r[j] for r in body])
                  for j, name in enumerate(header)},
                 index=np.arange(len(body)))
