"""Small tables in the reference's schemas, for the port's DataFrame
pickle and CSV readers (``tim_tpu_torch.utils.pdpickle``,
``tim_tpu_torch.data.table``).

Rewrite the fixture from the repository's root (needs pandas 3, which
writes its strings through pyarrow, and the JAX package's table
builders)::

    JAX_PLATFORMS=cpu python tests/data/torch_tables/make_fixture.py

The files, next to this script:

- ``EPIC_100_train.pkl``: EPIC-KITCHENS-100 annotations of 3 videos,
  written in pandas 1.x's layout by ``write_pandas1_pickle`` (pandas
  cannot write it any more): the frame through ``copyreg._reconstructor``,
  its ``BlockManager`` through ``NEWOBJ`` with the ``"0.14.1"`` state,
  whose block values are plain arrays, and the arrays through
  ``numpy.core.multiarray._reconstruct``;
- ``EPIC_100_validation.pkl``: one video's, in pandas 3's default layout
  (``str`` columns as pyarrow strings);
- ``EPIC_Sounds_{train,validation}.pkl``: EPIC-Sounds annotations of the
  same videos in pandas 3's layout with ``future.infer_string`` off
  (object columns);
- ``feature_times_train.pkl`` and ``feature_times_validation.pkl.gz``:
  ``tim_tpu.extract.tables.build_feature_time_table`` of the videos (the
  train table also holds a video with no annotation), ``video_info.pkl``:
  ``build_video_info`` of all of them;
- ``epic100_train.csv``: the train annotations in the finetune CLI's CSV
  schema, with quoted list fields and one empty field.

The videos are 150 s long (one 149.62 s); the annotations are out of
order, two pairs share a start time, one action is longer than a 30 s
window, one stops past its video's end, and one video in ``video_info``
has none. Each file has a ``.npz`` twin of its columns and index written
with ``allow_pickle=False`` (strings as unicode arrays with a mask of the
missing ones, list columns as JSON strings), which ``read_twin`` turns
into a ``Table`` with numpy alone, so that a machine without pandas can
check the readers.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN = {"P01_01": 150.0, "P01_02": 149.62, "P02_03": 150.0}
NO_ACTIONS = {"P02_04": 60.0}
VAL = {"P03_05": 150.0}
FPS = {"P01_01": 50.0, "P01_02": 50.0, "P02_03": 60.0, "P02_04": 60.0,
       "P03_05": 60.0}
VERBS = ["take", "put", "open", "close", "wash", "cut", "stir", "pour"]
NOUNS = ["tap", "water", "knife", "onion", "pan", "lid", "plate", "sponge"]
SOUNDS = ["rustle", "scrape", "water", "open / close", "cut / chop",
          "metal-only collision", "click", "footstep"]
PICKLES = ("EPIC_100_train.pkl", "EPIC_100_validation.pkl",
           "EPIC_Sounds_train.pkl", "EPIC_Sounds_validation.pkl",
           "feature_times_train.pkl", "feature_times_validation.pkl.gz",
           "video_info.pkl")
CSVS = ("epic100_train.csv",)


def twin_path(path: str) -> str:
    """``EPIC_100_train.pkl`` -> ``EPIC_100_train.npz`` (``.pkl.gz`` and
    ``.csv`` alike)."""
    base = os.path.basename(path)
    for ext in (".pkl.gz", ".pkl", ".csv"):
        if base.endswith(ext):
            return os.path.join(os.path.dirname(path),
                                base[:-len(ext)] + ".npz")
    raise ValueError(path)


# ---------------------------------------------------------------------------
# twins: numpy alone
# ---------------------------------------------------------------------------

def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _encode(values: np.ndarray):
    """(kind, arrays) of one column for ``np.savez``."""
    if values.dtype != object:
        return "number", {"": values}
    if any(isinstance(v, list) for v in values):
        return "json", {"": np.asarray([json.dumps(v) for v in values],
                                       dtype=str)}
    na = np.asarray([_is_nan(v) for v in values], bool)
    return "string", {"": np.asarray(["" if m else v for v, m in
                                      zip(values, na)], dtype=str),
                      "_na": na}


def _decode(kind: str, z, key: str) -> np.ndarray:
    values = z[key]
    if kind == "number":
        return values
    out = np.empty(len(values), object)
    if kind == "json":
        out[:] = [None] * len(values)
        for i, v in enumerate(values):
            out[i] = json.loads(str(v))
        return out
    na = z[key + "_na"]
    out[:] = [np.nan if m else str(v) for v, m in zip(values, na)]
    return out


def write_twin(table, path: str) -> None:
    """A ``Table``'s columns and index as ``.npz`` arrays (no pickles)."""
    arrays = {"columns": np.asarray(table.columns, dtype=str),
              "index_name": np.asarray(
                  [] if table.index_name is None else [table.index_name],
                  dtype=str)}
    kinds = []
    for j, name in enumerate(table.columns):
        kind, parts = _encode(table[name])
        kinds.append(kind)
        arrays.update({f"col{j}{k}": v for k, v in parts.items()})
    kind, parts = _encode(table.index)
    arrays.update({f"index{k}": v for k, v in parts.items()})
    arrays["kinds"] = np.asarray(kinds + [kind], dtype=str)
    assert all(a.dtype != object for a in arrays.values())
    np.savez_compressed(path, **arrays)


def read_twin(path: str):
    """The ``Table`` a twin holds (``np.load(allow_pickle=False)``)."""
    from tim_tpu_torch.data.table import Table
    with np.load(path, allow_pickle=False) as z:
        names = [str(c) for c in z["columns"]]
        kinds = [str(k) for k in z["kinds"]]
        cols = {name: _decode(kinds[j], z, f"col{j}")
                for j, name in enumerate(names)}
        index = _decode(kinds[-1], z, "index")
        index_name = [str(n) for n in z["index_name"]]
    return Table(cols, index=index,
                 index_name=index_name[0] if index_name else None)


# ---------------------------------------------------------------------------
# pandas 1.x's pickle layout, emitted by hand
# ---------------------------------------------------------------------------

class _Global:
    """A global by name, pickled as ``STACK_GLOBAL`` without importing it
    (the names of pandas 1.x and numpy 1.x)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *args):
        raise TypeError("a name in a pickle, never called")


class _Reduced:
    """An object pickled as ``func(*args)`` then ``BUILD(state)``."""

    def __init__(self, func, args, state=None):
        self.func, self.args, self.state = func, args, state

    def __reduce__(self):
        return (self.func, self.args) if self.state is None else \
            (self.func, self.args, self.state)


class _NewObj(_Reduced):
    """An object pickled as ``NEWOBJ`` of ``func`` with ``args``, then
    ``BUILD(state)`` (protocol 2 and later, for a class without a
    ``__reduce__``)."""


class _Pandas1Pickler(pickle._Pickler):
    """Protocol 4, with ``_Global``s as names and numpy arrays as numpy
    1.x pickles them (``numpy.core.multiarray._reconstruct`` and the
    ``ndarray`` state)."""

    dispatch = pickle._Pickler.dispatch.copy()

    def save_named_global(self, obj):
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    def save_array(self, arr):
        data = list(arr.ravel()) if arr.dtype == object else arr.tobytes()
        self.save_reduce(
            _Global("numpy.core.multiarray", "_reconstruct"),
            (_Global("numpy", "ndarray"), (0,), b"b"),
            (1, arr.shape, arr.dtype, False, data), obj=arr)

    def save_newobj(self, obj):
        self.save(obj.func)
        self.save(obj.args)
        self.write(pickle.NEWOBJ)
        self.memoize(obj)
        self.save(obj.state)
        self.write(pickle.BUILD)

    dispatch[_Global] = save_named_global
    dispatch[np.ndarray] = save_array
    dispatch[_NewObj] = save_newobj


def _reconstructed(module: str, name: str, state) -> _Reduced:
    return _Reduced(_Global("copyreg", "_reconstructor"),
                    (_Global(module, name), _Global("builtins", "object"),
                     None), state)


def _index(values, name) -> _Reduced:
    return _Reduced(_Global("pandas.core.indexes.base", "_new_Index"),
                    (_Global("pandas.core.indexes.base", "Index"),
                     {"data": np.asarray(values, object), "name": name}))


def write_pandas1_pickle(table, path: str, state_key: str = "_data") -> None:
    """``table`` (object and int64/float64/bool columns, a string index) as
    pandas 1.x pickled a DataFrame: consolidated blocks (one per dtype, in
    order of first column), ``mgr_locs`` as arrays, the frame's state
    under ``state_key`` (``_data`` before pandas 1.1, ``_mgr`` after)."""
    names = table.columns
    by_dtype = {}
    for j, name in enumerate(names):
        by_dtype.setdefault(table[name].dtype, []).append(j)
    columns = _index(names, None)
    axes = [columns, _index(table.index, table.index_name)]
    blocks = [(np.stack([table[names[j]] for j in locs]),
               np.asarray(locs, np.int64)) for locs in by_dtype.values()]
    state = (axes, [v for v, _ in blocks],
             [_index([names[j] for j in locs], None) for _, locs in blocks],
             {"0.14.1": {"axes": axes, "blocks": [
                 {"values": v, "mgr_locs": locs} for v, locs in blocks]}})
    manager = _NewObj(_Global("pandas.core.internals.managers",
                              "BlockManager"), (), state)
    frame_state = {state_key: manager,
        "_typ": "dataframe", "_metadata": [], "attrs": {}}
    if state_key == "_mgr":
        frame_state["_flags"] = {"allows_duplicate_labels": True}
    with open(path, "wb") as f:
        _Pandas1Pickler(f, protocol=4).dump(
            _reconstructed("pandas.core.frame", "DataFrame", frame_state))


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def timestamp(sec: float) -> str:
    h, rem = divmod(sec, 3600.0)
    m, s = divmod(rem, 60.0)
    return f"{int(h):02d}:{int(m):02d}:{s:06.3f}"


def epic100_rows(durations, rng):
    """EPIC-KITCHENS-100 annotation rows (narration_id first), out of
    order, with the edge cases of the module's docstring."""
    rows = []
    for vid, dur in durations.items():
        fps = FPS[vid]
        spans = []
        for _ in range(40):
            length = float(rng.uniform(0.5, 9.0))
            start = float(rng.uniform(0.0, dur - length))
            spans.append((round(start, 3), round(start + length, 3)))
        spans[3] = (spans[2][0], round(spans[2][0] + 4.25, 3))   # a tie
        spans[7] = (spans[8][0], round(spans[8][0] + 1.5, 3))    # another
        spans[11] = (20.0, 55.5)                          # > a 30 s window
        spans[15] = (round(dur - 2.0, 3), round(dur + 3.0, 3))   # past end
        for i, (start, stop) in enumerate(spans):
            n_nouns = 1 + int(rng.integers(0, 3))
            nouns = [int(n) for n in rng.choice(len(NOUNS), n_nouns,
                                                replace=False)]
            verb = int(rng.integers(0, len(VERBS)))
            rows.append({
                "narration_id": f"{vid}_{i}",
                "participant_id": vid[:3],
                "video_id": vid,
                "narration_timestamp": timestamp(start + 0.3),
                "start_timestamp": timestamp(start),
                "stop_timestamp": timestamp(stop),
                "start_frame": int(round(start * fps)),
                "stop_frame": int(round(stop * fps)),
                "narration": f"{VERBS[verb]} {NOUNS[nouns[0]]}",
                "verb": VERBS[verb],
                "verb_class": verb * 11 + int(rng.integers(0, 11)),
                "noun": NOUNS[nouns[0]],
                "noun_class": nouns[0] * 37 + int(rng.integers(0, 37)),
                "all_nouns": [NOUNS[n] for n in nouns],
                "all_noun_classes": [n * 37 for n in nouns],
            })
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def sounds_rows(durations, rng):
    """EPIC-Sounds annotation rows (annotation_id first), out of order."""
    rows = []
    for vid, dur in durations.items():
        for i in range(25):
            length = float(rng.uniform(0.3, 6.0))
            start = round(float(rng.uniform(0.0, dur - length)), 3)
            stop = round(start + length, 3)
            cls = int(rng.integers(0, len(SOUNDS)))
            rows.append({
                "annotation_id": f"{vid}_{i}",
                "participant_id": vid[:3],
                "video_id": vid,
                "start_timestamp": timestamp(start),
                "stop_timestamp": timestamp(stop),
                "start_sample": int(round(start * 24000)),
                "stop_sample": int(round(stop * 24000)),
                "description": f"{SOUNDS[cls]} sound",
                "class": SOUNDS[cls],
                "class_id": cls * 5 + int(rng.integers(0, 5)),
            })
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    import pandas as pd
    from tim_tpu.extract.tables import (
        build_feature_time_table, build_video_info)
    from tim_tpu_torch.data.table import Table

    rng = np.random.default_rng(17)
    out = {}

    def frame(rows, index):
        df = pd.DataFrame(rows)
        return df.set_index(index)

    rows = epic100_rows(TRAIN, rng)
    train = frame(rows, "narration_id")
    with pd.option_context("future.infer_string", False):
        want = frame(rows, "narration_id")      # pandas 1.x: object columns
    path = os.path.join(HERE, "EPIC_100_train.pkl")
    write_pandas1_pickle(Table.from_frame(want), path)
    back = pd.read_pickle(path)
    assert back.equals(want) and back.index.name == "narration_id" and list(
        back.columns) == list(want.columns), "pandas reads another frame"
    out["EPIC_100_train.pkl"] = Table.from_frame(want)

    val = frame(epic100_rows(VAL, rng), "narration_id")
    val.to_pickle(os.path.join(HERE, "EPIC_100_validation.pkl"))
    out["EPIC_100_validation.pkl"] = Table.from_frame(val)

    with pd.option_context("future.infer_string", False):
        for split, videos in (("train", TRAIN), ("validation", VAL)):
            df = frame(sounds_rows(videos, rng), "annotation_id")
            name = f"EPIC_Sounds_{split}.pkl"
            df.to_pickle(os.path.join(HERE, name))
            out[name] = Table.from_frame(df)

    ft = build_feature_time_table({**TRAIN, **NO_ACTIONS}, fps=FPS)
    ft.to_pickle(os.path.join(HERE, "feature_times_train.pkl"))
    out["feature_times_train.pkl"] = Table.from_frame(ft)
    ft = build_feature_time_table(VAL, fps=FPS)
    ft.to_pickle(os.path.join(HERE, "feature_times_validation.pkl.gz"),
                 compression={"method": "gzip", "mtime": 0})
    out["feature_times_validation.pkl.gz"] = Table.from_frame(ft)
    info = build_video_info({**TRAIN, **NO_ACTIONS, **VAL}, fps=FPS)
    info.to_pickle(os.path.join(HERE, "video_info.pkl"))
    out["video_info.pkl"] = Table.from_frame(info)

    csv = train.reset_index()
    csv.loc[csv.index[5], "narration"] = np.nan        # one empty field
    csv.to_csv(os.path.join(HERE, "epic100_train.csv"), index=False)
    out["epic100_train.csv"] = Table.from_frame(
        pd.read_csv(os.path.join(HERE, "epic100_train.csv")))

    for name, table in out.items():
        write_twin(table, twin_path(os.path.join(HERE, name)))
        assert read_twin(twin_path(os.path.join(HERE, name))).equals(table)
    sizes = {n: os.path.getsize(os.path.join(HERE, n)) for n in
             sorted(os.listdir(HERE)) if not n.endswith(".py")}
    print(json.dumps(sizes), sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
