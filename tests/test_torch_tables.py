"""The port's DataFrame pickle reader (``tim_tpu_torch/utils/pdpickle.py``)
and column table (``tim_tpu_torch/data/table.py``) against pandas, and
the windows and feature stores built from them against the JAX package's
from pandas, on the CPU:

- ``read_pickle`` / ``read_csv`` equal ``pd.read_pickle`` /
  ``pd.read_csv`` (through ``Table.from_frame``) and the ``.npz`` twins
  on every file of ``tests/data/torch_tables`` (pandas 1.x's layout,
  pandas 3's pyarrow strings, object columns, ``.pkl.gz``, the CSV), on
  each compression, and on frames built here (RangeIndex, NaN, bool,
  uint, list columns, the python- and arrow-backed string arrays, both
  state keys of pandas 1.x, pandas 1.x's chunked arrow strings,
  protocols 2 to 5);
- an unknown global, a categorical or datetime column, a nullable
  integer column and a ``MultiIndex`` are refused with the global, the
  column or the index named;
- ``read_csv``'s types (int64, float64 with NaN or decimals, strings,
  quoted lists) against ``pd.read_csv``;
- ``Table``'s operations against the pandas calls they replace (ties and
  NaN in ``sort_by``, ``groups``, ``unique``, ``concat`` with a missing
  column, ``reset_index``, ``to_numpy``);
- ``normalize_actions`` -> ``build_detection_windows`` /
  ``build_recognition_windows`` and ``FeatureStore.from_npy_dir`` from the
  fixture files exactly equal to ``tim_tpu.data``'s from pandas: every
  ``Window`` field, the ``WindowSet`` maxima, the feature times bit for
  bit.

(``cli.main`` and the ``evals`` main without pandas, against the JAX
CLI: ``tests/test_torch_cli.py``.)
"""

import collections
import dataclasses
import importlib.util
import os
import pickle

import numpy as np
import pytest

from tim_tpu.data import dataset as jds
from tim_tpu.data import windows as jwin
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.data.table import Table, read_csv
from tim_tpu_torch.utils.pdpickle import read_pickle

pd = pytest.importorskip("pandas")

HERE = os.path.join(os.path.dirname(__file__), "data", "torch_tables")
_spec = importlib.util.spec_from_file_location(
    "torch_tables_fixture", os.path.join(HERE, "make_fixture.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)


def _path(name):
    return os.path.join(HERE, name)


def _read(name):
    return read_csv(_path(name)) if name.endswith(".csv") else \
        read_pickle(_path(name))


def _pandas(name):
    return pd.read_csv(_path(name)) if name.endswith(".csv") else \
        pd.read_pickle(_path(name))


def _same(got: Table, frame):
    want = Table.from_frame(frame)
    assert got.equals(want), (got, want)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", fixture.PICKLES + fixture.CSVS)
def test_fixture_files_read_as_pandas_and_twins(name):
    got = _read(name)
    _same(got, _pandas(name))
    assert got.equals(fixture.read_twin(fixture.twin_path(_path(name))))
    assert len(got) > 0


def test_fixture_layouts_are_the_ones_named():
    """The train annotations are pandas 1.x's layout, the validation ones
    pandas 3's arrow strings, the EPIC-Sounds ones object columns."""
    def globals_of(name):
        import pickletools
        with open(_path(name), "rb") as f:
            ops = [(op.name, arg) for op, arg, _ in pickletools.genops(f)]
        strings = [arg for op, arg in ops if op.endswith("UNICODE")]
        return set(strings)
    train = globals_of("EPIC_100_train.pkl")
    assert {"copyreg", "_reconstructor", "numpy.core.multiarray",
            "0.14.1", "_data"} <= train and "_unpickle_block" not in train
    assert "ArrowStringArray" in globals_of("EPIC_100_validation.pkl")
    assert "ArrowStringArray" not in globals_of("EPIC_Sounds_train.pkl")
    info = _read("EPIC_100_train.pkl")
    assert isinstance(info["all_nouns"][0], list)


@pytest.fixture(scope="module")
def val_frame():
    return pd.read_pickle(_path("EPIC_100_validation.pkl"))


@pytest.mark.parametrize("ext", [".pkl", ".pkl.gz", ".pkl.bz2", ".pkl.xz",
                                 ".pkl.zip", ".pkl.zst"])
def test_each_compression(ext, val_frame, tmp_path):
    path = tmp_path / f"frame{ext}"
    if ext == ".pkl.zst" and importlib.util.find_spec("zstandard") is None:
        from tim_tpu_torch.utils import zstd
        with open(path, "wb") as f:
            f.write(zstd.compress(pickle.dumps(val_frame)))
    else:
        val_frame.to_pickle(path)
    _same(read_pickle(path), val_frame)


def _frames():
    rng = np.random.default_rng(3)
    n = 7
    base = pd.DataFrame({
        "f": rng.normal(size=n), "i": rng.integers(-5, 5, n),
        "u": rng.integers(0, 9, n).astype(np.uint16),
        "b": rng.integers(0, 2, n).astype(bool),
        "s": [f"é{i}" if i != 2 else None for i in range(n)],
        "l": [[int(i), "x"] if i % 3 else [] for i in range(n)],
    })
    base.loc[3, "f"] = np.nan
    out = {
        "range_index": base.set_index(pd.RangeIndex(10, 10 + 3 * n, 3,
                                                    name="row")),
        "string_index": base.set_index(
            pd.Index([f"n{i}" for i in range(n)], name="narration_id")),
        "int_index": base.set_index(pd.Index(np.arange(n) * 7, name="k")),
        "float32": pd.DataFrame({"x": np.arange(n, dtype=np.float32)}),
        "python_str": pd.DataFrame({"s": pd.array(
            ["a", None, "c"], dtype=pd.StringDtype("python",
                                                   na_value=np.nan))}),
        "string_na": pd.DataFrame({"s": pd.array(["a", None, "ç"],
                                                 dtype="string")}),
        "arrow_string_na": pd.DataFrame({"s": pd.array(
            ["a", None, "ç"], dtype="string[pyarrow]")}),
        "sliced_arrow": base.iloc[2:6],
        "empty": base.iloc[:0],
    }
    with pd.option_context("future.infer_string", False):
        out["object"] = pd.DataFrame(base.to_dict("list"))
    return out


FRAMES = _frames()


@pytest.mark.parametrize("protocol", [2, 4, 5])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_built_here(name, protocol, tmp_path):
    path = tmp_path / "f.pkl"
    FRAMES[name].to_pickle(path, protocol=protocol)
    _same(read_pickle(path), FRAMES[name])


@pytest.mark.parametrize("state_key", ["_data", "_mgr"])
def test_pandas1_layout_both_state_keys(state_key, tmp_path):
    """``make_fixture.write_pandas1_pickle`` (pandas 1.0's ``_data`` and
    1.1's ``_mgr``): pandas reads it to the frame, and so does the port."""
    with pd.option_context("future.infer_string", False):
        frame = pd.DataFrame({
            "video_id": ["a", "b", "c"], "n": [1, 2, 3],
            "x": [0.5, np.nan, 2.0], "flag": [True, False, True],
            "nouns": [["tap"], [], ["pan", "lid"]]},
            index=pd.Index(["i0", "i1", "i2"], name="narration_id"))
    path = tmp_path / "old.pkl"
    fixture.write_pandas1_pickle(Table.from_frame(frame), path, state_key)
    assert pd.read_pickle(path).equals(frame)
    _same(read_pickle(path), frame)


def test_arrow_strings_in_pandas1_state(monkeypatch, tmp_path):
    """pandas 1.x pickled ``string[pyarrow]`` columns with their state
    under ``_data`` as a ``ChunkedArray`` (``pyarrow.lib.chunked_array``
    of chunks): two chunks, a null, an offset slice."""
    pa = pytest.importorskip("pyarrow")
    from pandas.core.arrays.arrow.array import ArrowExtensionArray
    chunks = pa.chunked_array([pa.array(["a", None, "bé"]),
                               pa.array(["x", "yz", "w"]).slice(1)])
    frame = pd.DataFrame({"s": pd.arrays.ArrowStringArray(chunks)})
    monkeypatch.setattr(ArrowExtensionArray, "__getstate__", lambda self: {
        "_data": self._pa_array, "_dtype": self._dtype})
    path = tmp_path / "chunked.pkl"
    frame.to_pickle(path)
    assert b"chunked_array" in path.read_bytes()
    _same(read_pickle(path), pd.read_pickle(path))


class _Evil:
    def __reduce__(self):
        return (os.system, ("exit 3",))


@pytest.mark.parametrize("case,error,match", [
    ("global", pickle.UnpicklingError, r"collections\.OrderedDict"),
    ("os.system", pickle.UnpicklingError, r"(posix|nt)\.system"),
    ("categorical", ValueError, r"column 'c'.*Categorical"),
    ("datetime", ValueError, r"column 't'.*DatetimeArray"),
    ("nullable int", ValueError, r"column 'k'.*IntegerArray"),
    ("multiindex", ValueError, r"the index.*MultiIndex"),
    ("series", ValueError, r"Series.*not a DataFrame"),
])
def test_refused_with_the_name(case, error, match, tmp_path):
    path = tmp_path / "bad.pkl"
    obj = {"global": collections.OrderedDict(a=1), "os.system": _Evil(),
           "categorical": pd.DataFrame({"a": [1, 2], "c": pd.Categorical(
               ["x", "y"])}),
           "datetime": pd.DataFrame({"t": pd.to_datetime(["2020-01-01"])}),
           "nullable int": pd.DataFrame({"k": pd.array([1, None],
                                                       dtype="Int64")}),
           "multiindex": pd.DataFrame({"i": [1, 2]}, index=pd.MultiIndex
                                      .from_tuples([(1, 2), (3, 4)])),
           "series": pd.Series([1.0, 2.0])}[case]
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(error, match=match):
        read_pickle(path)


CSV_CASES = {
    "ints": "a,b\n1,2\n-3,4\n",
    "empty_int_is_float": "a,b\n1,\n2,5\n",
    "decimal": "a,b\n1.5,x\n2,y\n",
    "quoted": 'id,nouns,classes\nn0,"[\'tap\', \'water\']","[7, 27]"\n'
              'n1,"[\'pan\']",[3]\n',
    "na_strings": "a,b,c\nNA,x,\nnan,,1e3\n3,z,-2.5\n",
    "unnamed": ",v\n0,a\n1,b\n",
    "blank_lines": "a,b\n\n1,2\n\n3,4\n",
    "strings_with_numbers": "a\n1\nx\n",
    "big_int": "a\n9223372036854775807\n-9223372036854775808\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_read_csv_types_as_pandas(case, tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(CSV_CASES[case])
    _same(read_csv(path), pd.read_csv(path))


# ---------------------------------------------------------------------------
# Table's operations against pandas
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    n = 300
    start = np.round(rng.uniform(0, 20, n), 1)      # many ties
    start[::17] = np.nan
    with pd.option_context("future.infer_string", False):
        return pd.DataFrame({
            "video_id": [f"v{int(i)}" for i in rng.integers(0, 6, n)],
            "start_sec": start, "k": rng.integers(0, 4, n)},
            index=pd.Index([f"n{i}" for i in range(n)], name="nid"))


def test_sort_groups_unique_as_pandas(frame):
    t = Table.from_frame(frame)
    _same(t.sort_by("start_sec"), frame.sort_values("start_sec"))
    _same(t.sort_by("k"), frame.sort_values("k"))
    groups = t.groups("video_id")
    g = frame.groupby("video_id")
    assert list(groups) == list(g.groups)
    for key, rows in groups.items():
        _same(rows, g.get_group(key))
    assert t.unique("video_id").tolist() == frame["video_id"].unique() \
        .tolist()
    np.testing.assert_array_equal(t.unique("start_sec"),
                                  frame["start_sec"].unique())


def test_concat_reset_select_drop_to_numpy_as_pandas(frame):
    t = Table.from_frame(frame)
    a, b = frame.iloc[:100], frame.iloc[100:].drop(columns=["k"])
    _same(Table.concat([Table.from_frame(a), Table.from_frame(b)]),
          pd.concat([a, b], axis=0))
    _same(Table.concat([Table.from_frame(a), Table.from_frame(b)])
          .reset_index(drop=True),
          pd.concat([a, b], axis=0).reset_index(drop=True))
    _same(t.reset_index(), frame.reset_index())
    _same(t.select(["k", "video_id"]), frame[["k", "video_id"]])
    _same(t.drop(["video_id"]), frame.drop(columns=["video_id"]))
    num = t.drop(["video_id"])
    np.testing.assert_array_equal(
        num.to_numpy(np.float32),
        frame.drop(columns=["video_id"]).to_numpy(np.float32))
    mask = (frame["k"] == 2).to_numpy()
    _same(t.where(mask), frame[mask])
    _same(t.take([5, 1, 1]), frame.iloc[[5, 1, 1]])
    assert [(i, r["k"]) for i, r in t.rows()][:5] == [
        (i, r["k"]) for i, r in frame.iterrows()][:5]


# ---------------------------------------------------------------------------
# windows and feature stores from the files, against the JAX package
# ---------------------------------------------------------------------------

SPLITS = {"train": ("EPIC_100_train.pkl", "EPIC_Sounds_train.pkl",
                    "feature_times_train.pkl"),
          "validation": ("EPIC_100_validation.pkl",
                         "EPIC_Sounds_validation.pkl",
                         "feature_times_validation.pkl.gz")}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{split: (port FeatureStore, JAX FeatureStore)} over zero banks."""
    root = tmp_path_factory.mktemp("banks")
    out = {}
    for split, (_, _, times) in SPLITS.items():
        os.makedirs(root / split)
        ours = read_pickle(_path(times))
        for vid in ours.unique("video_id"):
            rows = int((ours["video_id"] == vid).sum())
            np.save(root / split / f"{vid}.npy",
                    np.zeros((rows, 1, 1), np.float32))
        out[split] = (pds.FeatureStore.from_npy_dir(str(root), split, ours),
                      jds.FeatureStore.from_npy_dir(str(root), split,
                                                    _pandas(times)))
    return out


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_feature_stores_equal_jax(split, stores):
    ours, theirs = stores[split]
    assert list(ours.feat_times) == list(theirs.feat_times)
    for vid, want in theirs.feat_times.items():
        got = ours.feat_times[vid]
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), vid


def _window_sets_equal(got, want):
    for f in ("max_visual_actions", "max_audio_actions", "num_actions",
              "window_size", "min_query", "max_query"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.windows) == len(want.windows) > 100
    for a, b in zip(got.windows, want.windows):
        for f in dataclasses.fields(b):
            x, y = (np.asarray(getattr(w, f.name)) for w in (a, b))
            assert x.dtype == y.dtype or x.size == y.size == 0, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("modality", ["audio_visual", "visual", "audio"])
@pytest.mark.parametrize("detection", [True, False])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_windows_from_the_files_equal_jax(split, detection, modality,
                                          stores):
    """At the CLI's EPIC defaults (50 features, stride 3, gap 0.2: 30 s
    windows)."""
    v_pkl, a_pkl, _ = SPLITS[split]
    window_size = 50 * 0.2 * 3

    def build(mod, read, store):
        f = (mod.build_detection_windows if detection
             else mod.build_recognition_windows)
        return f(*(mod.normalize_actions(read(_path(p)), m, "epic",
                                         detection=detection,
                                         window_size=window_size)
                   for p, m in ((v_pkl, "visual"), (a_pkl, "audio"))),
                 read(_path("video_info.pkl")), store.feat_times,
                 data_modality=modality)

    ours, theirs = stores[split]
    _window_sets_equal(build(pwin, read_pickle, ours),
                       build(jwin, pd.read_pickle, theirs))
