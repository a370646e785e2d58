"""The port's HDF5 reader (``tim_tpu_torch/utils/hdf5.py``) against h5py,
and the extraction CLI's ``--audio_hdf5`` route against the JAX CLI's, on
the CPU:

- every dataset of ``tests/data/torch_hdf5`` (h5py's defaults with a
  root B-tree of two levels; ``libver="earliest"`` and ``"latest"``
  layouts: filters, compact, fill values, the five chunk indexes of
  layout message 4, compact and dense groups) equals h5py's reading and
  its ``.npz`` twin bit for bit, dtype and shape too, and every group's
  ``keys()`` equals h5py's;
- a grid of files h5py writes here: libver {earliest, v108, latest} x
  layout {contiguous, compact, chunked} x filter {none, gzip, shuffle +
  gzip, fletcher32, lzf} x dtype {<f4, >f4, <f8, <i2, >i4, u1}, the
  filters on chunked storage only (h5py refuses them elsewhere); and
  other files (superblock 1, a user block, scalar and null dataspaces,
  creation-ordered groups, an extensible array on a later axis);
- reading a 60 s waveform of a file that holds others reads at most its
  bytes plus 64 KiB (a byte-counting file object);
- external links, external storage, SZIP and unknown filters, compound and
  string types, virtual datasets, a missing name, a flipped byte in a
  checksummed ``OHDR``, in a link heap's direct block and in a fletcher32
  chunk, a truncated file and a file that is not HDF5 are refused with
  errors that name them;
- lookup3 equals the published test vectors;
- in a process where h5py, pandas, pyarrow and JAX cannot be imported,
  ``extract.cli.main --backbone slowfast --audio_hdf5 --num_aug 2`` on the
  small SlowFast gives the JAX CLI's banks (run with h5py here) within
  1e-4 of the largest feature, both sets, on ``epic_audio.h5`` and on a
  chunked gzip ``<i2`` copy (the unscaled integer cast kept).
"""

import functools
import importlib.util
import io
import itertools
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tim_tpu_torch.utils import hdf5

h5py = pytest.importorskip("h5py")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "tests", "data", "torch_hdf5")
_spec = importlib.util.spec_from_file_location(
    "torch_hdf5_fixture", os.path.join(HERE, "make_fixture.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)


def _walk(group, out, prefix="/"):
    """Every dataset a walk of the reader's groups reaches, by path; each
    group's keys held to h5py's on the way."""
    for key in group.keys():
        obj = group[key]
        if isinstance(obj, hdf5.Group):
            _walk(obj, out, prefix + key + "/")
        else:
            out[prefix + key] = obj
    return out


def _same(got: np.ndarray, want: np.ndarray, name: str):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        name, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), name


def _keys_equal(ours, theirs, name="/"):
    assert list(ours.keys()) == list(theirs.keys()), name
    for key in theirs.keys():
        if isinstance(theirs[key], h5py.Group):
            _keys_equal(ours[key], theirs[key], name + key + "/")


def _equal_to_h5py(path, twins=None):
    """Every dataset and group of ``path`` through both readers (and each
    dataset against its twin, where given)."""
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        _keys_equal(f, h)
        ours = _walk(f, {})
        assert sorted(ours) == sorted(fixture.walk(h, {}))
        for name, ds in ours.items():
            want = h[name][()]
            if isinstance(want, h5py.Empty):
                assert ds.shape is None and ds.read().size == 0
                assert ds.dtype == want.dtype
                continue
            assert ds.shape == want.shape and ds.dtype == want.dtype
            _same(ds.read(), want, name)
            _same(np.asarray(ds), want, name)
        if twins is not None:
            assert sorted(ours) == sorted(twins)
            for key, want in twins.items():
                _same(ours[key].read(), want, key)
        return ours


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", fixture.H5_FILES)
def test_fixture_equals_h5py_and_twins(name):
    path = os.path.join(HERE, name)
    ours = _equal_to_h5py(path, fixture.read_twin(path))
    with open(path, "rb") as f:
        version = f.read(9)[8]
    assert version == (3 if name == "layouts_latest.h5" else 0)
    if name == "epic_audio.h5":
        assert fixture.root_btree_level(path) >= 1 and len(ours) >= 300
        for vid, seconds in fixture.WAVEFORMS.items():
            assert ours["/" + vid].shape == (
                round(seconds * fixture.SAMPLING_RATE),)


def test_fixture_covers_every_index_and_group_kind():
    """The structures the fixture is there for, as the reader saw them."""
    with hdf5.File(os.path.join(HERE, "layouts_latest.h5")) as f:
        index = {k: f["index/" + k]._index for k in f["index"].keys()}
        assert set(index.values()) == {"single", "implicit", "farray",
                                       "earray", "btree2"}
        fixed = f["index/fixed_paged"]
        assert fixed._index == "farray" and fixed.shape == (3000,)
        types = {m[0] for m in f["dense_group"]._messages}
        assert hdf5.MSG_LINK_INFO in types and hdf5.MSG_LINK not in types
        assert {m[0] for m in f["compact_group"]._messages} >= {
            hdf5.MSG_LINK}
    with hdf5.File(os.path.join(HERE, "layouts_earliest.h5")) as f:
        assert {k: f[k]._filters[-1][0] for k in ("gzip", "fletcher32",
                                                  "lzf")} == {
            "gzip": 1, "fletcher32": 3, "lzf": 32000}
        assert [x[0] for x in f["shuffle_gzip"]._filters] == [2, 1]
        assert f["compact"]._cls == 0 and f["never_written"]._address is None
        np.testing.assert_array_equal(f["never_written"].read(), 4.25)


# ---------------------------------------------------------------------------
# files h5py writes here
# ---------------------------------------------------------------------------

FILTERS = {"none": {}, "gzip": {"compression": "gzip"},
           "shuffle_gzip": {"compression": "gzip", "shuffle": True},
           "fletcher32": {"fletcher32": True}, "lzf": {"compression": "lzf"}}
GRID = [(lib, layout, flt, dt) for lib, layout, flt, dt in itertools.product(
    ("earliest", "v108", "latest"), ("contiguous", "compact", "chunked"),
    FILTERS, ("<f4", ">f4", "<f8", "<i2", ">i4", "u1"))
    if layout == "chunked" or flt == "none"]


@pytest.mark.parametrize("libver,layout,flt,dtype", GRID)
def test_written_grid(libver, layout, flt, dtype, tmp_path):
    rng = np.random.default_rng(len(libver) * 7 + len(flt) + len(dtype))
    data = (rng.normal(size=(2, 700)) * 90).astype(dtype)
    path = tmp_path / "grid.h5"
    with h5py.File(path, "w", libver=libver) as f:
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            ds = h5py.h5d.create(f.id, b"x", h5py.h5t.py_create(data.dtype),
                                 h5py.h5s.create_simple(data.shape),
                                 dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        else:
            kw = dict(FILTERS[flt], chunks=(1, 128)) \
                if layout == "chunked" else {}
            f.create_dataset("x", data=data, **kw)
    with hdf5.File(path) as f:
        got = f["x"]
        assert got._cls == {"compact": 0, "contiguous": 1, "chunked": 2}[
            layout]
        _same(got.read(), data, "x")
        _same(np.asarray(got, np.float32), data.astype(np.float32), "cast")


def _superblock_1(h5py, path):
    """A non-default indexed-storage K makes HDF5 write superblock 1; h5py
    has no call for it, so its own libhdf5 is called through ctypes."""
    import ctypes
    import glob
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        h5py.__file__)), "h5py.libs", "libhdf5-*.so*"))
    assert libs, "h5py's libhdf5 is not a separate library here"
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    assert ctypes.CDLL(libs[0]).H5Pset_istore_k(
        ctypes.c_int64(fcpl.id), ctypes.c_uint(64)) >= 0
    with h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC,
                                   fcpl=fcpl)) as f:
        f.create_dataset("c", data=np.arange(5000.0), chunks=(64,),
                         compression="gzip")
        f.create_group("g").create_dataset("s", data=np.int16(-3))


def _user_block(h5py, path):
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("a", data=np.arange(300, dtype="<i4"))


def _spaces(h5py, path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("scalar", data=np.float32(2.5))
        f.create_dataset("null", data=h5py.Empty("<f8"))
        f.create_dataset("zero", shape=(0,), dtype="<f4")
        f.create_dataset("zero_chunked", shape=(0, 3), maxshape=(None, 3),
                         dtype="<f4")


def _track_order(h5py, path):
    with h5py.File(path, "w", track_order=True) as f:
        for name in ("zeta", "alpha", "mid"):
            f[name] = np.arange(3)
        g = f.create_group("dense", track_order=True)
        for i in range(20):
            g[f"z{20 - i:02d}"] = np.arange(i + 1)


def _later_axis(h5py, path):
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("e", shape=(3, 4, 500), maxshape=(3, 4, None),
                             chunks=(2, 3, 16), dtype="<f8",
                             compression="gzip", fillvalue=-7)
        d[:, :, :300] = np.arange(3600.0).reshape(3, 4, 300)
        d = f.create_dataset("b", shape=(5, 6, 7), maxshape=(None, 6, None),
                             chunks=(2, 2, 2), dtype="u1")
        d[1:4] = 9


@pytest.mark.parametrize("make", [_superblock_1, _user_block, _spaces,
                                  _track_order, _later_axis],
                         ids=lambda f: f.__name__.strip("_"))
def test_other_files(make, tmp_path):
    path = tmp_path / "other.h5"
    make(h5py, path)
    _equal_to_h5py(path)
    with open(path, "rb") as f:
        head = f.read(1033)
    if make is _superblock_1:
        assert head[8] == 1
    if make is _user_block:
        assert head[1024 + 8] == 0


class CountingReader(io.RawIOBase):
    """A file opened for reading that counts the bytes it returns."""

    def __init__(self, path):
        self.f, self.name, self.count = open(path, "rb", buffering=0), \
            str(path), 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, pos, whence=0):
        return self.f.seek(pos, whence)

    def tell(self):
        return self.f.tell()

    def readinto(self, b):
        n = self.f.readinto(b)
        self.count += n or 0
        return n

    def close(self):
        self.f.close()
        super().close()


def test_a_read_takes_its_bytes_and_64_kib(tmp_path):
    """A 60 s float32 waveform among 300 one-sample datasets and four
    20 s waveforms (h5py's defaults): opening the file and reading it
    through ``np.asarray(f[vid], np.float32)`` reads its stored bytes plus
    at most 64 KiB."""
    rng = np.random.default_rng(3)
    path = tmp_path / "audio.h5"
    names = fixture.epic_names()
    long = rng.normal(scale=0.1, size=60 * 24000).astype(np.float32)
    with h5py.File(path, "w") as f:
        for i, name in enumerate(names):
            f.create_dataset(name, data=(
                long if name == "P17_04" else
                rng.normal(size=20 * 24000).astype(np.float32) if i % 80 == 7
                else np.float32([i])))
    reader = CountingReader(path)
    with hdf5.File(reader) as f:
        got = np.asarray(f["P17_04"], np.float32)
    _same(got, long, "P17_04")
    assert reader.count <= long.nbytes + 64 * 1024, reader.count
    assert os.path.getsize(path) > 2 * long.nbytes


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _external_link(path, tmp):
    with h5py.File(path, "w") as f:
        f["x"] = h5py.ExternalLink("elsewhere.h5", "/y")
    return "x", ValueError, "external link"


def _external_storage(path, tmp):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", shape=(10,), dtype="<f4",
                         external=[(str(tmp / "raw.bin"), 0, 40)])
    return "x", ValueError, "external storage"


def _patched_filter(fid):
    def make(path, tmp):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(100.0), chunks=(10,),
                             compression="gzip")
        data = bytearray(path.read_bytes())
        at = data.index(b"deflate\0") - 8       # pipeline version 1: the id
        assert data[at:at + 2] == b"\x01\x00"
        data[at:at + 2] = fid.to_bytes(2, "little")
        path.write_bytes(bytes(data))
        name = hdf5.FILTER_NAMES.get(fid, "deflate")
        return "x", ValueError, f"filter {fid} \\({name}\\)"
    make.__name__ = f"_filter_{fid}"
    return make


def _compound(path, tmp):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros(3, [("a", "<f4"), ("b", "<i2")]))
    return "x", ValueError, "class 6 \\(compound\\)"


def _string(path, tmp):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.array([b"ab", b"cd"]))
    return "x", ValueError, "class 3 \\(string\\)"


def _virtual(path, tmp):
    with h5py.File(tmp / "src.h5", "w") as f:
        f["s"] = np.arange(4.0)
    layout = h5py.VirtualLayout(shape=(4,), dtype="<f8")
    layout[:] = h5py.VirtualSource(str(tmp / "src.h5"), "s", shape=(4,))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("x", layout)
    return "x", ValueError, "virtual dataset"


def _missing(path, tmp):
    shutil.copy(os.path.join(HERE, "epic_audio.h5"), path)
    return "P99_99", KeyError, "P99_99"


def _flipped_ohdr(path, tmp):
    src = os.path.join(HERE, "layouts_latest.h5")
    with hdf5.File(src) as f:
        kind, addr = f["index"]._find("fixed_paged")
    data = bytearray(open(src, "rb").read())
    assert kind == "hard" and data[addr:addr + 4] == b"OHDR"
    data[addr + 30] ^= 0x10
    path.write_bytes(bytes(data))
    return ("index/fixed_paged", ValueError,
            "OHDR of /index/fixed_paged at [0-9]+: checksum mismatch")


def _flipped_fhdb(path, tmp):
    """A byte flipped in every direct block of the file's link heaps."""
    data = bytearray(open(os.path.join(HERE, "layouts_latest.h5"),
                          "rb").read())
    at = data.find(b"FHDB")
    while at >= 0:
        data[at + 40] ^= 0x01
        at = data.find(b"FHDB", at + 4)
    path.write_bytes(bytes(data))
    return ("dense_group/clip_00", ValueError,
            "FHDB of /dense_group at [0-9]+: checksum mismatch")


def _flipped_fletcher(path, tmp):
    src = os.path.join(HERE, "layouts_earliest.h5")
    with h5py.File(src, "r") as f:
        info = f["fletcher32"].id.get_chunk_info(1)
    data = bytearray(open(src, "rb").read())
    data[info.byte_offset + 100] ^= 0x01
    path.write_bytes(bytes(data))
    return "fletcher32", ValueError, "fletcher32 checksum mismatch"


def _truncated(path, tmp):
    data = open(os.path.join(HERE, "epic_audio.h5"), "rb").read()
    path.write_bytes(data[:len(data) - 5000])
    return None, OSError, "truncated: the superblock's end-of-file address"


def _not_hdf5(path, tmp):
    path.write_bytes(b"RIFF" + bytes(3000))
    return None, OSError, "not an HDF5 file"


REFUSALS = [_external_link, _external_storage, _patched_filter(4),
            _patched_filter(32123), _compound, _string, _virtual, _missing,
            _flipped_ohdr, _flipped_fhdb, _flipped_fletcher, _truncated,
            _not_hdf5]


@pytest.mark.parametrize("make", REFUSALS,
                         ids=lambda f: f.__name__.strip("_"))
def test_refused_with_its_name(make, tmp_path):
    path = tmp_path / "bad.h5"
    name, kind, match = make(path, tmp_path)
    with pytest.raises(kind, match=match) as err:
        with hdf5.File(path) as f:
            np.asarray(f[name], np.float32)
    assert str(path) in str(err.value)
    if name is not None and kind is not KeyError:
        assert "/" + name.split("/")[0] in str(err.value)


def test_lookup3_vectors():
    """``hashlittle`` values (initval 0) printed by lookup3.c's own test
    program."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551


# ---------------------------------------------------------------------------
# the CLI without h5py
# ---------------------------------------------------------------------------

# Runs the port's extraction CLI where h5py, pandas, pyarrow and JAX cannot
# be imported: argv[1] is a JSON spec (the small SlowFast's widths and the
# runs); prints the packages loaded.
NO_H5PY_RUN = """
import functools, json, random, sys
for name in ("h5py", "pandas", "pyarrow", "jax"):
    sys.modules[name] = None
from tim_tpu_torch.extract import cli
from tim_tpu_torch.models.backbones import slowfast as psf
spec = json.loads(sys.argv[1])
psf.AuditorySlowFast = functools.partial(psf.AuditorySlowFast,
                                         **spec["small"])
for argv in spec["runs"]:
    random.seed(0)
    cli.main(argv, device="cpu")
print(json.dumps({"loaded": sorted(
    m for m in ("h5py", "pandas", "pyarrow", "jax", "tim_tpu")
    if sys.modules.get(m) is not None)}))
"""


def test_audio_hdf5_cli_without_h5py_matches_jax(tmp_path, monkeypatch):
    from tests.test_torch_audio import SMALL, _small_port_model
    from tim_tpu.extract import cli as jcli
    from tim_tpu.models.backbones import slowfast as jsf

    torch.save({"model_state": _small_port_model().state_dict()},
               tmp_path / "asf.pyth")
    epic = os.path.join(HERE, "epic_audio.h5")
    ints = tmp_path / "epic_i2.h5"
    twins = fixture.read_twin(epic)
    first = sorted(fixture.WAVEFORMS)[0]
    with h5py.File(ints, "w") as f:
        for vid in (first,):
            f.create_dataset(vid, data=np.round(
                twins["/" + vid] * 32767).astype("<i2"), chunks=(4096,),
                compression="gzip")

    def argv(path, out):
        return ["--backbone", "slowfast", "--audio_hdf5", str(path),
                "--feature_times", os.path.join(HERE, "feature_times.pkl"),
                "--checkpoint", str(tmp_path / "asf.pyth"),
                "--out_dir", str(tmp_path / out), "--split", "val",
                "--num_aug", "2", "--batch_size", "8"]

    # the integer copy holds the first video only: the shard that reads it
    files = {"f32": (epic, []), "i2": (ints, ["--num_shards", "3",
                                             "--shard_id", "0"])}
    spec = {"small": SMALL, "runs": [argv(p, f"port_{k}") + extra
                                     for k, (p, extra) in files.items()]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", NO_H5PY_RUN, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))

    monkeypatch.setattr(jsf, "AuditorySlowFast",
                        functools.partial(jsf.AuditorySlowFast, **SMALL))
    compiled = {}                   # one jit of the JAX model for both files
    orig = jcli._make_audio_apply
    monkeypatch.setattr(jcli, "_make_audio_apply",
                        lambda args: compiled.setdefault(0, orig(args)))
    for key, (path, extra) in files.items():
        random.seed(0)
        jcli.main(argv(path, f"jax_{key}") + extra)

    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    assert json.loads(out.strip().splitlines()[-1])["loaded"] == []
    for key in files:
        for vid in fixture.WAVEFORMS if key == "f32" else (first,):
            got, want = (np.load(tmp_path / f"{side}_{key}" / "val" /
                                 f"{vid}.npy") for side in ("port", "jax"))
            assert got.shape == want.shape and want.shape[1:] == (2, 8 * 40)
            scale = np.abs(want).max()
            err = np.abs(got.astype(np.float64) - want).max()
            assert err <= 1e-4 * scale, (key, vid, err, scale)
    assert not np.allclose(
        np.load(tmp_path / "jax_i2" / "val" / f"{first}.npy"),
        np.load(tmp_path / "jax_f32" / "val" / f"{first}.npy"))
