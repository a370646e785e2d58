"""Small HDF5 files as h5py writes them, for the port's HDF5 reader
(``tim_tpu_torch.utils.hdf5``) and the ``--audio_hdf5`` route of the
extraction CLI.

Rewrite the fixture from the repository's root (needs h5py, pandas and
``tim_tpu.extract.tables``)::

    JAX_PLATFORMS=cpu python tests/data/torch_hdf5/make_fixture.py

The files, next to this script:

- ``epic_audio.h5``, in h5py's defaults (superblock 0, old-style groups,
  contiguous float32): 320 root-level datasets named like EPIC videos,
  enough for the root group's B-tree to have an internal level (checked
  here on the node's level byte). Three are 24 kHz waveforms of 2.0, 2.4
  and 3.0 s (16-bit samples scaled to [-1, 1), as decoded PCM is); the
  rest hold one sample each;
- ``layouts_earliest.h5`` (``libver="earliest"``): chunked datasets with
  gzip, shuffle + gzip, fletcher32 and lzf (edge chunks in one and two
  axes), compact storage, a partly written chunked dataset and a never
  written contiguous one (fill values), ``<f8``, ``<i2``, ``>f4`` and
  ``u1`` data, a scalar, a 2-D ``[2, N]`` waveform, a nested group and a
  soft link;
- ``layouts_latest.h5`` (``libver="latest"``): a group of 5 links
  (compact) and one of 60 (dense: a fractal heap whose root is an
  indirect block, and a name index of two levels), and
  datasets on each of the five chunk indexes of layout message 4 (single
  chunk, filtered and not; implicit; fixed array, one of 3000 chunks in
  pages of 1024 with its middle page never written; extensible array,
  one unlimited axis first and one second; version 2 B-tree, filtered
  and not);
- ``feature_times.pkl``: ``tim_tpu.extract.tables.build_feature_time_table``
  of the three waveforms, in pandas 1.x's layout
  (``tests/data/torch_tables/make_fixture.py::write_pandas1_pickle``),
  which the port reads without pandas.

Each ``.h5`` file has an ``.npz`` twin holding every dataset that a walk
of its groups reaches (soft links included) under its path with ``/`` as
``:``, written by ``np.savez_compressed``; ``feature_times.npz`` is the
table's twin (``write_twin``). ``read_twin`` needs numpy alone, so a
machine without h5py can check the reader.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H5_FILES = ("epic_audio.h5", "layouts_earliest.h5", "layouts_latest.h5")
SAMPLING_RATE = 24000
# the three waveforms: video id -> seconds
WAVEFORMS = {"P01_05": 2.0, "P12_03": 2.4, "P30_10": 3.0}
PARTICIPANTS, VIDEOS_EACH = 32, 10


def twin_path(path: str) -> str:
    """``epic_audio.h5`` -> ``epic_audio.npz``."""
    return os.path.splitext(path)[0] + ".npz"


def read_twin(path: str) -> dict:
    """dataset path -> array, from an ``.h5`` file's twin (numpy alone)."""
    with np.load(twin_path(path), allow_pickle=False) as z:
        return {"/" + k.replace(":", "/"): z[k] for k in z.files}


def tables_fixture():
    """``tests/data/torch_tables/make_fixture.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_tables_fixture",
        os.path.join(os.path.dirname(HERE), "torch_tables", "make_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def waveform(seconds: float, seed: int) -> np.ndarray:
    """Tones, a decaying onset and noise, as 16-bit samples / 32768."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * SAMPLING_RATE))) / SAMPLING_RATE
    x = sum(rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * rng.uniform(80, 4000)
                                            * t + rng.uniform(0, 6.28))
            for _ in range(4))
    x = x + 0.4 * np.exp(-8 * np.abs(t - seconds / 2)) * rng.normal(
        size=len(t)) + rng.normal(scale=0.02, size=len(t))
    pcm = np.clip(np.round(x * 32767), -32768, 32767)
    return (pcm / 32768).astype(np.float32)


def epic_names() -> list:
    return [f"P{p:02d}_{v:02d}" for p in range(1, PARTICIPANTS + 1)
            for v in range(1, VIDEOS_EACH + 1)]


def root_btree_level(path: str) -> int:
    """The level byte of the root group's B-tree node, read from the
    superblock (version 0, 8-byte offsets) by hand."""
    with open(path, "rb") as f:
        head = f.read(96)
        assert head[8] == 0 and head[13] == 8, "superblock 0, 8-byte offsets"
        btree = struct.unpack_from("<Q", head, 80)[0]
        f.seek(btree)
        node = f.read(8)
    assert node[:4] == b"TREE" and node[4] == 0, node
    return node[5]


def group(h5py, parent, path: str):
    """``parent.create_group(path)`` without modification times (HDF5
    stamps groups by default), so that the files are the same every run."""
    for name in path.split("/"):
        gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
        gcpl.set_obj_track_times(False)
        parent = h5py.Group(h5py.h5g.create(parent.id, name.encode(),
                                            gcpl=gcpl))
    return parent


def write_epic(h5py, path: str) -> None:
    with h5py.File(path, "w") as f:
        for i, name in enumerate(epic_names()):
            if name in WAVEFORMS:
                data = waveform(WAVEFORMS[name], seed=i)
            else:
                data = np.asarray([((i * 37) % 101 - 50) / 64.0], np.float32)
            f.create_dataset(name, data=data)


def write_earliest(h5py, path: str, rng) -> None:
    wave = waveform(0.125, seed=101)
    with h5py.File(path, "w", libver="earliest") as f:
        f.create_dataset("gzip", data=wave, chunks=(256,),
                         compression="gzip")
        f.create_dataset("shuffle_gzip", data=wave.astype("<f8"),
                         chunks=(200,), shuffle=True, compression="gzip",
                         compression_opts=6)
        f.create_dataset("fletcher32", data=(wave * 32767).astype("<i2"),
                         chunks=(500,), fletcher32=True)
        f.create_dataset("lzf", data=wave.astype(">f4"), chunks=(300,),
                         compression="lzf")
        f.create_dataset("chunked_2d", data=np.stack([wave, -wave]),
                         chunks=(1, 700), shuffle=True, compression="gzip")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dcpl.set_obj_track_times(False)
        compact = rng.integers(0, 256, 500).astype("u1")
        ds = h5py.h5d.create(f.id, b"compact",
                             h5py.h5t.py_create(compact.dtype),
                             h5py.h5s.create_simple(compact.shape), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, compact)
        part = f.create_dataset("partial", shape=(1000,), chunks=(64,),
                                dtype="<f4", fillvalue=-2.5)
        part[100:300] = wave[:200]
        f.create_dataset("never_written", shape=(50,), dtype="<f8",
                         fillvalue=4.25)
        types = group(h5py, f, "types")
        types.create_dataset("f8", data=rng.normal(size=300))
        types.create_dataset("i2", data=rng.integers(-32768, 32767, 300,
                                                     dtype="<i2"))
        types.create_dataset("be_f4", data=rng.normal(size=300).astype(">f4"))
        types.create_dataset("u1", data=rng.integers(0, 256, 300).astype(
            "u1"))
        f.create_dataset("scalar", data=np.float64(0.1))
        f.create_dataset("stereo", data=np.stack([wave, wave[::-1]]))
        group(h5py, f, "nested/a/b").create_dataset("wave", data=wave[:1000])
        f["link_to_wave"] = h5py.SoftLink("/nested/a/b/wave")


def write_latest(h5py, path: str, rng) -> None:
    wave = waveform(0.25, seed=102)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)         # the root group's times
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC,
                                   fcpl=fcpl, fapl=fapl)) as f:
        g = group(h5py, f, "compact_group")
        for i in range(5):
            g.create_dataset(f"d{i}", data=rng.normal(size=i + 1))
        g = group(h5py, f, "dense_group")
        for i in range(60):
            g.create_dataset(f"clip_{(i * 17) % 60:02d}",
                             data=rng.integers(0, 100, i + 1, dtype="<i4"))
        g = group(h5py, f, "index")
        g.create_dataset("single", data=wave[:1000], chunks=(1000,))
        g.create_dataset("single_gzip", data=wave[:1000].reshape(2, 500),
                         chunks=(2, 500), compression="gzip")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((250,))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        dcpl.set_obj_track_times(False)
        ds = h5py.h5d.create(g.id, b"implicit", h5py.h5t.IEEE_F32LE,
                             h5py.h5s.create_simple((1100,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, wave[:1100])
        fixed = g.create_dataset("fixed_paged", shape=(3000,), chunks=(1,),
                                 dtype="<f4", fillvalue=0.5)
        fixed[:1024] = wave[:1024]
        fixed[2048:2900] = wave[2048:2900]
        g.create_dataset("fixed_gzip", data=wave[:5000], chunks=(100,),
                         compression="gzip", fletcher32=True)
        ea = g.create_dataset("extensible", shape=(6000,), maxshape=(None,),
                              chunks=(16,), dtype="<f4", shuffle=True,
                              compression="gzip")
        ea[:5500] = wave[:5500]
        ea2 = g.create_dataset("extensible_2d", shape=(2, 3000),
                               maxshape=(2, None), chunks=(1, 64),
                               dtype="<f4", fillvalue=-1.0)
        ea2[:, :2500] = np.stack([wave[:2500], wave[1000:3500]])
        bt = g.create_dataset("btree2_gzip", shape=(2, 3000),
                              maxshape=(None, None), chunks=(1, 50),
                              dtype="<f4", compression="gzip")
        bt[:, :2800] = np.stack([wave[:2800], wave[3000:5800]])
        bt = g.create_dataset("btree2", shape=(3, 300), maxshape=(None, None),
                              chunks=(2, 64), dtype=">i2")
        bt[:2] = (np.stack([wave[:300], wave[300:600]]) * 32767).astype(">i2")


def walk(group, out: dict, prefix: str = "/") -> dict:
    """Every dataset a walk of h5py's groups reaches, by path."""
    import h5py
    for key in group.keys():
        obj = group[key]
        if isinstance(obj, h5py.Group):
            walk(obj, out, prefix + key + "/")
        else:
            out[prefix + key] = obj[()]
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    import h5py
    from tim_tpu.extract.tables import build_feature_time_table
    from tim_tpu_torch.data.table import Table

    rng = np.random.default_rng(18)
    write_epic(h5py, os.path.join(HERE, "epic_audio.h5"))
    write_earliest(h5py, os.path.join(HERE, "layouts_earliest.h5"), rng)
    write_latest(h5py, os.path.join(HERE, "layouts_latest.h5"), rng)
    level = root_btree_level(os.path.join(HERE, "epic_audio.h5"))
    assert level >= 1, f"the root B-tree has no internal level ({level})"
    for name in H5_FILES:
        path = os.path.join(HERE, name)
        with h5py.File(path, "r") as f:
            datasets = walk(f, {})
        np.savez_compressed(twin_path(path), **{
            k[1:].replace("/", ":"): v for k, v in datasets.items()})
        back = read_twin(path)
        assert sorted(back) == sorted(datasets) and all(
            back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
            for k, v in datasets.items())

    tables = tables_fixture()
    ft = build_feature_time_table(WAVEFORMS, fps=50.0)
    table = Table.from_frame(ft)
    path = os.path.join(HERE, "feature_times.pkl")
    tables.write_pandas1_pickle(table, path)
    import pandas as pd
    assert Table.from_frame(pd.read_pickle(path)).equals(table)
    tables.write_twin(table, twin_path(path))
    assert tables.read_twin(twin_path(path)).equals(table)

    sizes = {}
    for n in sorted(os.listdir(HERE)):
        if not n.endswith(".py"):
            with open(os.path.join(HERE, n), "rb") as f:
                data = f.read()
            sizes[n] = [len(data), hashlib.sha256(data).hexdigest()[:12]]
    print(json.dumps(sizes), sum(v[0] for v in sizes.values()), "bytes;",
          "root B-tree level", level)


if __name__ == "__main__":
    main()
