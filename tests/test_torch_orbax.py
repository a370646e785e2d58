"""The JAX package's orbax checkpoint directories in the port
(``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/orbax.py``,
``train/checkpoint.py``'s ``load_checkpoint_orbax`` /
``save_checkpoint_orbax``), on the CPU at small widths:

- zstd through libzstd against ``zstandard``: levels 1, 3 and 19, empty
  and multi-block inputs, frames with and without a content size; bad
  frames raise, a missing library raises ``RuntimeError``;
- OCDBT: the reader lists the keys and values that tensorstore's ``ocdbt``
  kvstore lists, on JAX saves from one device, from 8 devices sharded over
  a model axis (several chunks an array) and from two JAX processes
  (``tests/torch_orbax_worker.py``), on every ``ocdbt.process_<i>`` store
  of them, and on tensorstore stores with interior nodes, values in data
  files and older versions; tensorstore reads what the writer writes;
- payloads: ``load_checkpoint_orbax`` equals JAX's leaf for leaf (dtype,
  shape, bits, the empty optax states) for detection, recognition and
  MAE states;
- JAX to the port: a JAX ``DetectionRunner`` saved with
  ``save_checkpoint_orbax`` and resumed through ``cli.run --resume``
  holds JAX's state exactly, and one more step on both sides agrees
  within 1e-4 of each tensor's largest value (the k-bias third within
  2 lr); ``--pretrained_model`` and the finetune CLI's ``--pretrained``
  give JAX's warnings;
- the port to JAX: the port's ``save_checkpoint_orbax`` restores in JAX's
  ``load_checkpoint_orbax``, its ``load_checkpoint`` fallback and its
  runner's ``resume`` bit-equal to the state (TIM and MAE), its JSON
  files equal those of JAX's own save of that state;
- the newest committed epoch is read, uncommitted ones skipped; a flipped
  byte in a chunk, a truncated data file and a flipped node byte raise
  ``ValueError`` naming the key or the node;
- the committed fixture ``tests/data/torch_orbax`` (written by JAX, read
  on the card by ``chip_smoke.py``) equals what JAX reads from it, and
  its orbax payload equals its msgpack twin. ``python -m
  tests.test_torch_orbax`` writes it anew.
"""

import dataclasses
import json
import logging
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard
from flax import serialization

from tests import test_torch_detection_train as tdet
from tests import test_torch_jax_checkpoint as tjc
from tests.torch_port_helpers import port_train_cfg
from tim_tpu import config as C
from tim_tpu.data import dataset as jds
from tim_tpu.models import queries as JQ
from tim_tpu.runner import DetectionRunner as JaxDetectionRunner
from tim_tpu.train import checkpoint as jckpt
from tim_tpu.train.optim import make_optimizer
from tim_tpu.train.state import create_train_state
from tim_tpu_torch import convert
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.train import checkpoint as ckpt
from tim_tpu_torch.train import detection as pdet
from tim_tpu_torch.utils import msgpack as pmsgpack
from tim_tpu_torch.utils import ocdbt, orbax, zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_orbax_worker.py")
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_orbax")
LR = tjc.LR
EXTRA = {"val_stats": {"loss": 1.25, "top1": 37.5}, "seen": 7, "ok": True}
CLI_WIDTHS = ["--num_feats", str(tjc.NUM_FEATS), "--feat_stride", "2",
              "--d_model", "16", "--nhead", "2", "--num_layers", "2",
              "--visual_input_dim", "24", "--audio_input_dim", "16",
              "--compute_dtype", "float32", "--batch-size", "8", "--seed",
              "0"]


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def _zstd_inputs():
    rng = np.random.default_rng(0)
    return {"empty": b"", "one": b"x",
            "floats": rng.normal(size=70000).astype(np.float32).tobytes(),
            "mixed": (b"tim-tpu " * 40000
                      + rng.integers(0, 7, 300000, np.uint8).tobytes()),
            "zeros": bytes(500000)}


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decodes_what_zstandard_encodes(level):
    for name, data in _zstd_inputs().items():
        sized = zstandard.ZstdCompressor(level=level).compress(data)
        stream = zstandard.ZstdCompressor(level=level,
                                          write_content_size=False)
        obj = stream.compressobj()
        unsized = obj.compress(data) + obj.flush()
        for frame in (sized, unsized):
            assert bytes(zstd.decompress(frame)) == data, name
            out = torch.empty(len(data), dtype=torch.uint8)
            zstd.decompress(frame, out)
            assert out.numpy().tobytes() == data, name
        if len(data) > 1 << 17:      # more than one 128 KiB block
            params = zstandard.get_frame_parameters(unsized)
            assert params.content_size == zstandard.CONTENTSIZE_UNKNOWN


def test_zstd_frames_decode_in_zstandard_and_carry_a_checksum():
    for name, data in _zstd_inputs().items():
        frame = bytes(zstd.compress(data))
        assert zstandard.ZstdDecompressor().decompress(frame) == data, name
        params = zstandard.get_frame_parameters(frame)
        assert params.has_checksum and params.content_size == len(data)


def test_zstd_rejects_bad_frames(monkeypatch):
    data = _zstd_inputs()["floats"]
    frame = bytes(zstd.compress(data))
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x10
    for bad, match in ((frame[:-6], "truncated"), (frame + b"\0", "follow"),
                       (bytes(flipped), "zstd")):
        with pytest.raises(ValueError, match=match):
            zstd.decompress(bad)
    with pytest.raises(ValueError, match="more than"):
        zstd.decompress(frame, bytearray(len(data) - 1))
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress(frame, bytearray(len(data) + 1))
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda _: None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-missing.so.1")
    with pytest.raises(RuntimeError, match="libzstd-missing"):
        zstd.decompress(frame)


# ---------------------------------------------------------------------------
# JAX saves
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_state(kind, seed=0):
    """A JAX train state of ``kind`` (detection / recognition: TIM with
    ``make_optimizer``; mae: ``optax.adamw``): seeded parameters, Adam
    moments (nu > 0) and a count of 3."""
    import optax
    if kind == "mae":
        shapes = tjc._backbone_param_shapes("mae")
        tx = optax.adamw(1.5e-4, weight_decay=0.05)
    else:
        shapes = tjc._tim_param_shapes(tjc._configs(kind)[0])
        tx = make_optimizer(LR, 1e-4, 10, 2)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               tx, normaliser=4.0)
    sd = serialization.to_state_dict(state.opt_state)
    adam = sd["0"] if kind == "mae" else sd["inner_state"]["1"]["0"]
    adam["mu"] = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.normal(scale=1e-3, size=s.shape),
                              jnp.float32), shapes)
    adam["nu"] = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(1e-8, 1e-6, s.shape),
                              jnp.float32), shapes)
    adam["count"] = jnp.int32(3)
    if kind != "mae":
        sd["inner_state"]["1"]["2"]["count"] = jnp.int32(3)
    return state.replace(step=jnp.int32(3), opt_state=serialization
                         .from_state_dict(state.opt_state, sd))


@pytest.fixture(scope="module")
def two_process_workers(tmp_path_factory):
    """The two JAX processes of ``tests/torch_orbax_worker.py``, started
    here and awaited by ``two_process_save`` (the tests between run
    meanwhile)."""
    out = str(tmp_path_factory.mktemp("two_process"))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, "2", str(pid), port,
                               out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for pid in range(2)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def two_process_save(two_process_workers):
    """The directory the two processes saved, with the gathered leaves
    their process 0 wrote."""
    out, procs = two_process_workers
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return out


@pytest.fixture(scope="module")
def jax_saves(tmp_path_factory, two_process_workers):
    """JAX's orbax directories by name: single-device detection,
    recognition and MAE states and the detection state sharded over 8
    devices (data 4 x model 2)."""
    from tim_tpu.parallel import make_mesh, shard_train_state
    tmp = tmp_path_factory.mktemp("jax_saves")
    saves = {}
    for kind in ("detection", "recognition", "mae"):
        saves[kind] = str(tmp / kind)
        jckpt.save_checkpoint_orbax(saves[kind], _jax_state(kind), epoch=1,
                                    extra=EXTRA)
    saves["sharded"] = str(tmp / "sharded")
    jckpt.save_checkpoint_orbax(
        saves["sharded"], shard_train_state(_jax_state("detection"),
                                            make_mesh(4, 2)), epoch=2)
    return saves


def _step_dir(path):
    root = os.path.join(path, "orbax")
    return os.path.join(root, max(os.listdir(root), key=int))


def _tensorstore(path):
    import tensorstore as ts
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(path)}/"}
                         ).result()
    keys = kv.list().result()
    reads = [kv.read(k) for k in keys]
    return {k.decode(): r.result().value for k, r in zip(keys, reads)}


def _assert_store_equals_tensorstore(path):
    want = _tensorstore(path)
    got = ocdbt.read_store(path)
    assert list(got) == sorted(want), path
    for key, value in want.items():
        assert bytes(got[key]) == value, key
    return got


def _assert_save_lists_as_tensorstore(path, processes, sharded):
    step = _step_dir(path)
    got = _assert_store_equals_tensorstore(step)
    parts = sorted(d for d in os.listdir(step) if d.startswith("ocdbt."))
    assert len(parts) == processes
    for part in parts:
        _assert_store_equals_tensorstore(os.path.join(step, part))
    chunks = [k for k in got if k.startswith("params.encoder.layer0."
                                             "self_attn.q.kernel/")
              and not k.endswith(".zarray")]
    # sharded over the model axis, replicas writing parts: several chunks
    assert (len(chunks) > 1) == sharded, chunks


@pytest.mark.parametrize("name", ["detection", "sharded"])
def test_ocdbt_reader_lists_what_tensorstore_lists(jax_saves, name):
    _assert_save_lists_as_tensorstore(jax_saves[name], 1, name == "sharded")


def test_ocdbt_reader_on_tensorstore_layouts(tmp_path):
    """Stores written by tensorstore itself: interior nodes and values in
    data files (small node and inline limits), and a manifest whose
    older versions sit in version tree nodes (one commit a key)."""
    import tensorstore as ts
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/deep/",
            "config": {"max_inline_value_bytes": 8,
                       "max_decoded_node_bytes": 300}}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn).write(f"key{i:03d}",
                                           bytes([i]) * (i % 13)).result()
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/versions/"}).result()
    for i in range(40):
        kv.write(f"k/{i:02d}", os.urandom(i * 9)).result()
    for store in ("deep", "versions"):
        assert len(_assert_store_equals_tensorstore(
            str(tmp_path / store))) == (60 if store == "deep" else 40)


@pytest.mark.parametrize("node_bytes", [ocdbt.MAX_DECODED_NODE_BYTES, 2000])
def test_tensorstore_reads_what_the_writer_writes(tmp_path, node_bytes,
                                                  monkeypatch):
    """One leaf, and (nodes of at most 2000 bytes) leaves under an
    interior node; values inline and in the data file."""
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    rng = np.random.default_rng(1)
    items = [(f"a{i:03d}/{'x' * (i % 5)}", rng.integers(
        0, 256, int(rng.integers(0, 3000)), np.uint8).tobytes())
        for i in range(200)]
    ocdbt.write_store(str(tmp_path), iter(items))
    for store in (tmp_path, tmp_path / "ocdbt.process_0"):
        assert _tensorstore(store) == dict(items)
        _assert_store_equals_tensorstore(str(store))
    with pytest.raises(ValueError, match="out of order"):
        ocdbt.write_store(str(tmp_path / "bad"), iter(items[::-1]))


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def _assert_payload_equal(got, want):
    """The port's tree against JAX's restore (or a decoded msgpack
    payload): the same keys in the same order, array leaves of the same
    dtype, shape and bits, Python numbers of the same type."""
    tjc._assert_tree_equal(got, jax.tree_util.tree_map(
        lambda x: (x.numpy() if isinstance(x, torch.Tensor) else
                   np.asarray(x) if isinstance(x, jax.Array) else x), want))


def test_zarr_chunks_in_fortran_order_with_edges_and_a_missing_one(
        tmp_path):
    """tensorstore's zarr store over OCDBT writes an F-order array in
    chunks that do not divide it, one chunk never written: the port reads
    what tensorstore reads (edge chunks cropped, the missing one at the
    fill value)."""
    import tensorstore as ts
    arr = ts.open({
        "driver": "zarr", "path": "arr", "create": True,
        "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
        "metadata": {"shape": [5, 7], "chunks": [2, 3], "order": "F",
                     "dtype": "<f4", "fill_value": 1.5,
                     "compressor": {"id": "zstd", "level": 1}}}).result()
    data = np.arange(35, dtype=np.float32).reshape(5, 7)
    arr[:4, :].write(data[:4]).result()
    arr[4:, 3:].write(data[4:, 3:]).result()
    got = orbax.read_array(ocdbt.read_store(str(tmp_path)), "arr")
    want = arr.read().result()
    assert want[4, 0] == 1.5 and want[4, 3] == 31
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["detection", "recognition", "mae",
                                  "sharded"])
def test_payload_equals_jax_leaf_for_leaf(jax_saves, name):
    got = ckpt.load_checkpoint_orbax(jax_saves[name])
    want = jckpt.load_checkpoint_orbax(jax_saves[name])
    _assert_payload_equal(got, want)
    empty = (got["opt_state"]["1"] if name == "mae"
             else got["opt_state"]["inner_state"]["0"])
    assert empty == {}
    if name != "sharded":
        assert got["extra"] == EXTRA


# ---------------------------------------------------------------------------
# JAX -> the port -> JAX, through the runners
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """JAX's runner takes 2 steps and saves orbax/1; ``cli.run --resume``
    reads it into the port's runner; both take a third step; the port
    saves orbax/2; JAX reads it (``load_checkpoint_orbax``, the
    ``load_checkpoint`` fallback, ``resume``) and saves it again; both
    take a fourth step."""
    from tim_tpu_torch import cli
    tmp = tmp_path_factory.mktemp("round_trip")
    cfg, pcfg, tcfg = tjc._configs("detection")
    jtrain, jval = tjc._splits("detection", jds, tjc.jwin)
    ptrain, pval = tjc._splits("detection", pds, pwin)
    jrun = JaxDetectionRunner(cfg, tcfg, jtrain, jval,
                              mesh_cfg=C.MeshConfig(data=1),
                              use_device_bank=False)
    batches = [{k: v for k, v in b.items() if not k.startswith("_")}
               for b in jds.batch_iterator(jtrain, tcfg.batch_size,
                                           shuffle=False)][:4]
    rng = jax.random.PRNGKey(5)
    nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]

    def jax_step(i):
        jrun.state, metrics = jrun._train_step(
            jrun.state, {k: jnp.asarray(v) for k, v in batches[i].items()},
            rng)
        return float(metrics["loss"])

    def jax_now():
        s = jrun.state
        return tjc._jax_record("detection", s.params, s.opt_state, s.step,
                               s.normaliser)

    out = {"A": str(tmp / "A"), "C": str(tmp / "C"), "D": str(tmp / "D")}
    jrun.init_state()
    for i in range(2):
        jax_step(i)
    jckpt.save_checkpoint_orbax(out["A"], jrun.state, epoch=1, extra=EXTRA)
    out["jax2"] = jax_now()

    runners = []
    make_runner = cli.make_runner

    def recording(*args, **kwargs):
        runners.append(make_runner(*args, **kwargs))
        return runners[-1]

    argv = ["--output_dir", str(tmp / "out"), "--validate", "--resume",
            out["A"], "--variant", "detection"] + CLI_WIDTHS
    orig = (cli.make_runner, cli.configs_from_args)
    cli.make_runner = recording
    cli.configs_from_args = lambda a: (pcfg, port_train_cfg(tcfg))
    try:
        out["stats"] = cli.run(cli.build_parser().parse_args(argv), ptrain,
                               pval, device="cpu")
    finally:
        cli.make_runner, cli.configs_from_args = orig
    prun = runners[0]
    out["port2"] = tjc._port_record(prun.state)
    pstep = pdet.make_train_step(prun.model, pcfg, port_train_cfg(tcfg),
                                 draws=tdet._jax_draws(cfg, tcfg, rng, nq))

    def port_step(i):
        metrics = pstep(prun.state, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in batches[i].items()})
        return float(metrics["loss"])

    out["loss3"] = jax_step(2), port_step(2)
    out["jax3"], out["port3"] = jax_now(), tjc._port_record(prun.state)
    out["sizes"] = ckpt.save_checkpoint_orbax(out["C"], prun.state, epoch=2,
                                              extra=EXTRA)
    for how, load in (("orbax", jckpt.load_checkpoint_orbax),
                      ("fallback", jckpt.load_checkpoint)):
        p = load(out["C"])
        out[f"jax_read_{how}"] = tjc._jax_record(
            "detection", p["params"], p["opt_state"], p["step"],
            p["normaliser"])
        out[f"extra_{how}"] = p["extra"]
    out["epoch_C"] = jrun.resume(out["C"])
    out["jax_C"] = jax_now()
    # a one-process save of plain arrays (the runner's are on its mesh)
    plain = jax.tree_util.tree_map(lambda x: jax.device_put(np.asarray(x)),
                                   jrun.state)
    jckpt.save_checkpoint_orbax(out["D"], plain, epoch=2, extra=EXTRA)
    out["loss4"] = jax_step(3), port_step(3)
    out["jax4"], out["port4"] = jax_now(), tjc._port_record(prun.state)
    return out


def test_jax_orbax_resumes_in_the_port_through_cli(round_trip):
    r = round_trip
    assert r["port2"]["step"] == 2
    tjc._assert_records_equal(r["port2"], r["jax2"])
    assert all(np.isfinite(v) for v in r["stats"].values())


def test_a_step_after_the_orbax_resume_agrees_with_jax(round_trip):
    r = round_trip
    np.testing.assert_allclose(r["loss3"][1], r["loss3"][0],
                               rtol=tjc.REL_TOL)
    tjc._assert_records_close(r["port3"], r["jax3"])


def test_port_orbax_restores_in_jax_exactly(round_trip):
    r = round_trip
    for how in ("orbax", "fallback"):
        tjc._assert_records_equal(r["port3"], r[f"jax_read_{how}"])
        assert r[f"extra_{how}"] == EXTRA
    assert r["epoch_C"] == 2
    tjc._assert_records_equal(r["port3"], r["jax_C"])
    np.testing.assert_allclose(r["loss4"][1], r["loss4"][0],
                               rtol=tjc.REL_TOL)
    tjc._assert_records_close(r["port4"], r["jax4"])


def test_port_orbax_files_equal_jaxs_own_save(round_trip):
    """JAX's save of the state it resumed from the port's directory: the
    same JSON files, field by field (timestamps aside), the same keys in
    the store, and the same decoded chunks."""
    port, jax_dir = (_step_dir(round_trip[k]) for k in ("C", "D"))
    for name in (orbax.METADATA, orbax.SHARDING,
                 os.path.join(orbax.ARRAY_METADATAS, "process_0")):
        with open(os.path.join(port, name)) as f, \
                open(os.path.join(jax_dir, name)) as g:
            assert json.load(f) == json.load(g), name
    with open(os.path.join(port, orbax.CHECKPOINT_METADATA)) as f, \
            open(os.path.join(jax_dir, orbax.CHECKPOINT_METADATA)) as g:
        got, want = json.load(f), json.load(g)
    stamps = ("init_timestamp_nsecs", "commit_timestamp_nsecs")
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in stamps} == \
        {k: v for k, v in want.items() if k not in stamps}
    got, want = ocdbt.read_store(port), ocdbt.read_store(jax_dir)
    assert list(got) == list(want)
    for key in want:
        a, b = (bytes(v) for v in (got[key], want[key]))
        if not key.endswith(".zarray"):
            a, b = (zstandard.ZstdDecompressor().decompressobj()
                    .decompress(x) for x in (a, b))
        assert a == b, key
    assert round_trip["sizes"]["values"] > 0


def test_mae_state_saved_as_orbax_restores_in_jax_exactly(tmp_path):
    import optax
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    from tim_tpu_torch.train.state import TrainState
    model = PretrainVideoMAE(img_size=32, patch_size=8, embed_dim=16,
                             depth=2, num_heads=2, num_frames=4,
                             tubelet_size=2, decoder_dim=8, decoder_depth=2,
                             decoder_heads=2, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    state = TrainState(model, opt)
    state.step = 1
    ckpt.save_checkpoint_orbax(str(tmp_path), state, epoch=1)
    jstate = create_train_state(
        tjc._random_like(tjc._backbone_param_shapes("mae")),
        optax.adamw(1e-3, weight_decay=0.05))
    restored = jckpt.restore_train_state(
        jstate, jckpt.load_checkpoint(str(tmp_path)))
    adam = serialization.to_state_dict(restored.opt_state)["0"]
    assert int(adam["count"]) == 1 and int(restored.step) == 1
    names = [n for n, _ in model.named_parameters()]
    moments = opt.state_dict()["state"]
    for tree, want in (
            (restored.params, dict(model.named_parameters())),
            (adam["mu"], {names[i]: s["exp_avg"] for i, s in moments.items()}),
            (adam["nu"], {names[i]: s["exp_avg_sq"]
                          for i, s in moments.items()})):
        got = convert.mae_state_dict_from_jax({"params": tree})
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert torch.equal(got[name], w.detach()), name


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------

def test_pretrained_model_through_cli_run_warns_as_jax(tmp_path,
                                                       monkeypatch):
    """An orbax-only JAX directory whose action head has another class
    count and which holds an entry the model lacks: ``cli.run --validate
    --pretrained_model`` merges it with JAX's warnings."""
    from tim_tpu_torch import cli
    cfg, pcfg, tcfg = tjc._configs("detection")
    params = tjc._random_like(tjc._tim_param_shapes(cfg), seed=3)
    file_params = {**params,
                   "cls_head": {**params["cls_head"],
                                "fc_action": {"kernel": np.ones((32, 9),
                                                                np.float32),
                                              "bias": np.ones(9, np.float32)}},
                   "unused_head": {"kernel": np.ones((2, 2), np.float32)}}
    state = create_train_state(file_params, make_optimizer(LR, 0.0, 10, 1))
    jckpt.save_checkpoint_orbax(str(tmp_path / "jax"), state, epoch=3)
    with tjc._Warnings("tim_tpu.train.checkpoint") as want:
        jckpt.shape_matched_merge(serialization.to_state_dict(params),
                                  jckpt.load_checkpoint(
                                      str(tmp_path / "jax"))["params"])
    assert len(want.messages) == 3, want.messages
    argv = ["--output_dir", str(tmp_path / "out"), "--validate",
            "--pretrained_model", str(tmp_path / "jax"), "--variant",
            "detection"] + CLI_WIDTHS
    monkeypatch.setattr(cli, "configs_from_args",
                        lambda a: (pcfg, port_train_cfg(tcfg)))
    with tjc._Warnings("tim_tpu_torch.train.checkpoint") as got:
        stats = cli.run(cli.build_parser().parse_args(argv),
                        *tjc._splits("detection", pds, pwin), device="cpu")
    assert got.messages == want.messages
    assert all(np.isfinite(v) for v in stats.values())


def test_finetune_cli_pretrained_from_a_jax_orbax_mae_directory(tmp_path):
    """A JAX ``PretrainVideoMAE`` state in an orbax-only directory, read
    by the finetune CLI's ``--pretrained`` (``load_pretrained_encoder``):
    JAX's warnings, the encoder loaded into the ViT trunk."""
    from tim_tpu.models.backbones.vit import VideoMAEViT as JaxViT
    from tim_tpu_torch.extract import finetune_cli as pcli
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    state = _jax_state("mae", seed=4)
    jckpt.save_checkpoint_orbax(str(tmp_path / "pre"), state, epoch=1)
    trunk_shapes = jax.eval_shape(lambda: JaxViT(
        img_size=32, patch_size=8, embed_dim=16, depth=2, num_heads=2,
        num_frames=4, tubelet_size=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3))))["params"]
    with tjc._Warnings("tim_tpu.train.checkpoint") as want:
        jckpt.shape_matched_merge(
            tjc._random_like(trunk_shapes),
            jckpt.load_checkpoint(str(tmp_path / "pre"))["params"])
    trunk = VideoMAEViT(img_size=32, patch_size=8, embed_dim=16, depth=2,
                        num_heads=2, num_frames=4, tubelet_size=2,
                        device="cpu")
    with tjc._Warnings("tim_tpu_torch.train.checkpoint") as got:
        params, missing = pcli.load_pretrained_encoder(
            str(tmp_path / "pre"), trunk)
    assert got.messages == want.messages
    assert missing == ["fc_norm.weight", "fc_norm.bias"]
    encoder = convert.mae_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)})
    for name, t in params.items():
        if name not in missing:
            assert torch.equal(t, encoder[name]), name


# ---------------------------------------------------------------------------
# epochs and faults
# ---------------------------------------------------------------------------

def _port_state():
    """A small port detection train state after one optimizer update."""
    from tim_tpu_torch.runner.detection import DetectionRunner
    _, pcfg, tcfg = tjc._configs("detection")
    runner = DetectionRunner(pcfg, port_train_cfg(tcfg),
                             *tjc._splits("detection", pds, pwin),
                             use_device_bank=False, device="cpu")
    runner.init_state()
    gen = torch.Generator().manual_seed(2)
    for p in runner.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    runner.state.optimizer.step()
    runner.state.step = 1
    return runner.state


def test_newest_committed_epoch_is_read(tmp_path):
    state = _port_state()
    for epoch in (1, 3):
        ckpt.save_checkpoint_orbax(str(tmp_path), state, epoch=epoch,
                                   extra={"epoch_seen": epoch})
    shutil.copytree(tmp_path / "orbax" / "3",
                    tmp_path / "orbax" / "7.orbax-checkpoint-tmp-1234")
    assert sorted(os.listdir(tmp_path / "orbax")) == [
        "1", "3", "7.orbax-checkpoint-tmp-1234"]
    assert ckpt.load_checkpoint(str(tmp_path))["extra"] == {"epoch_seen": 3}
    assert jckpt.load_checkpoint(str(tmp_path))["extra"] == {"epoch_seen": 3}
    assert ckpt.load_checkpoint_orbax(str(tmp_path), epoch=1)["extra"] == {
        "epoch_seen": 1}
    # a save over an epoch replaces it and leaves no temporary directory
    ckpt.save_checkpoint_orbax(str(tmp_path), state, epoch=3,
                               extra={"epoch_seen": 33})
    assert ckpt.load_checkpoint(str(tmp_path))["extra"] == {"epoch_seen": 33}
    assert len(os.listdir(tmp_path / "orbax")) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint_orbax(str(tmp_path / "none"))
    with pytest.raises(TypeError, match="str"):
        ckpt.save_checkpoint_orbax(str(tmp_path), state, epoch=4,
                                   extra={"note": "text"})
    assert not os.path.exists(tmp_path / "orbax" / "4")


@pytest.fixture
def port_dir(tmp_path):
    ckpt.save_checkpoint_orbax(str(tmp_path), _port_state(), epoch=1)
    step = os.path.join(tmp_path, "orbax", "1")
    locations = {}
    ocdbt.read_store(step, locations=locations)
    return tmp_path, step, locations


def test_flipped_chunk_byte_raises_with_the_key(port_dir):
    path, step, locations = port_dir
    key = "params.encoder.layer0.linear1.kernel/0.0"
    rel, offset, length = locations[key]
    with open(os.path.join(step, rel), "r+b") as f:
        f.seek(offset + length // 2)
        b = f.read(1)
        f.seek(offset + length // 2)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ckpt.load_checkpoint(str(path))


def test_truncated_data_file_raises_with_the_key(port_dir):
    path, step, locations = port_dir
    key, (rel, offset, length) = max(locations.items(),
                                     key=lambda kv: kv[1][1])
    with open(os.path.join(step, rel), "r+b") as f:
        f.truncate(offset + length - 1)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ckpt.load_checkpoint(str(path))


def test_flipped_node_byte_raises_with_the_node(port_dir):
    path, step, _ = port_dir
    nodes = os.listdir(os.path.join(step, "d"))
    assert len(nodes) == 1
    node = os.path.join(step, "d", nodes[0])
    with open(node, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(ValueError, match=f"{nodes[0]}.*crc32c"):
        ckpt.load_checkpoint(str(path))


# ---------------------------------------------------------------------------
# the fixture of chip_smoke's phase 26
# ---------------------------------------------------------------------------

def fixture_config() -> C.DetectionConfig:
    return C.DetectionConfig(
        visual_classes=(4,), audio_classes=3, visual_input_dim=24,
        audio_input_dim=16, d_model=16, nhead=2, num_layers=2, num_feats=8,
        feedforward_scale=1, train_query_size=0.1, inference_query_size=0.2,
        compute_dtype="float32")


def write_fixture(path: str = FIXTURE) -> None:
    """Write ``tests/data/torch_orbax`` with the JAX package: a small
    ``TimDetection`` train state (seeded parameters, one update on seeded
    gradients) saved by ``save_checkpoint_orbax`` (``orbax/1``) and by
    ``save_checkpoint`` (``checkpoint.msgpack``), and ``config.json``,
    its ``DetectionConfig``."""
    cfg = fixture_config()
    rng = np.random.default_rng(16)
    shapes = tjc._tim_param_shapes(cfg)
    params, grads = (jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        for _ in range(2))
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               make_optimizer(1e-3, 1e-4, 10, 2),
                               normaliser=6.0)
    state = state.apply_gradients(grads=grads)
    shutil.rmtree(path, ignore_errors=True)
    extra = {"val_stats": {"loss": 0.75}}
    jckpt.save_checkpoint_orbax(path, state, epoch=1, extra=extra)
    jckpt.save_checkpoint(path, state, epoch=1, extra=extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)


def test_fixture_equals_what_jax_reads_and_its_msgpack_twin():
    got = ckpt.load_checkpoint_orbax(FIXTURE)
    _assert_payload_equal(got, jckpt.load_checkpoint_orbax(FIXTURE))
    twin = pmsgpack.load(os.path.join(FIXTURE, "checkpoint.msgpack"))
    _assert_payload_equal(got, jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, twin))
    with open(os.path.join(FIXTURE, "config.json")) as f:
        cfg = json.load(f)
    assert cfg == json.loads(json.dumps(dataclasses.asdict(
        fixture_config())))
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 1_000_000, size


def test_two_process_save_reads_as_tensorstore_and_gathered_leaves(
        two_process_save):
    """Two JAX processes' save (``ocdbt.process_0`` and ``_1``, each
    with its shards): the reader lists what tensorstore lists, and the
    payload equals the leaves the processes gathered."""
    _assert_save_lists_as_tensorstore(two_process_save, 2, True)
    got = ckpt.load_checkpoint(two_process_save)
    flat = ckpt._flatten(got)
    with np.load(os.path.join(two_process_save, "leaves.npz")) as z:
        assert len(z.files) > 100
        for name in z.files:
            g, w = flat[name.replace(".", "/")], z[name]
            assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
            assert g.numpy().tobytes() == w.tobytes(), name
    assert got["extra"] == {"loss": 0.5} and int(got["epoch"]) == 3


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    logging.basicConfig(level=logging.INFO)
    write_fixture()
    print(f"wrote {FIXTURE}")
