"""The JAX package's msgpack checkpoints in the port (``utils/msgpack.py``,
``convert.py``'s ``*_params_to_jax``, ``train/optim.py``'s optax mapping,
``train/checkpoint.py``), on the CPU at small widths:

- the codec against flax: the port's decode equals
  ``flax.serialization.msgpack_restore`` leaf for leaf and bit for bit
  (fp32, fp16, bf16, every int width, bool, 0-d and empty arrays, numpy
  scalars, Python scalars, lists, complex), its encoder's bytes equal
  ``msgpack_serialize``'s, chunked leaves both ways, bad files raise;
- every ``*_params_to_jax`` inverts its ``*_from_jax`` exactly;
- JAX to the port: a JAX ``DetectionRunner`` / ``RecognitionRunner``
  takes 2 steps and saves; the port's runner resumes the directory with
  JAX's parameters, moments, counters, step, normaliser and epoch
  exactly, writes the same file back byte for byte
  (``save_jax_checkpoint``, a non-empty ``extra``), and one more step on
  both sides (the port handed JAX's draws) agrees within 1e-4 of each
  tensor's largest value (the k-bias third of ``in_proj_bias``, whose
  gradient is 0 in exact arithmetic, within 2 lr);
- the port to JAX: the port's file after that step (and its
  ``best_<tag>.msgpack`` copies) resumes in JAX's runner exactly, and a
  fourth step on both sides agrees as above; a ``PretrainVideoMAE`` state
  (``torch.optim.AdamW``) restores into JAX's ``optax.adamw`` state
  exactly;
- ``--pretrained_model`` through ``cli.run`` and the finetune CLI's
  ``--pretrained`` on a JAX MAE file: the warnings (loaded, missing,
  mismatched, unused) are JAX's ``shape_matched_merge``'s;
- an orbax-only directory is read as JAX reads it.
"""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests import test_torch_detection_train as tdet
from tests import test_torch_recognition as trec
from tests.torch_port_helpers import port_cfg, port_tables, port_train_cfg
from tim_tpu import config as C
from tim_tpu.data import dataset as jds
from tim_tpu.data import synthetic as jsyn
from tim_tpu.data import windows as jwin
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models import TimRecognition as JaxTimRecognition
from tim_tpu.models import queries as JQ
from tim_tpu.runner import DetectionRunner as JaxDetectionRunner
from tim_tpu.runner import RecognitionRunner as JaxRecognitionRunner
from tim_tpu.train import checkpoint as jckpt
from tim_tpu_torch import config as PC
from tim_tpu_torch import convert
from tim_tpu_torch.data import dataset as pds
from tim_tpu_torch.data import windows as pwin
from tim_tpu_torch.runner.detection import DetectionRunner
from tim_tpu_torch.runner.recognition import RecognitionRunner
from tim_tpu_torch.train import checkpoint as ckpt
from tim_tpu_torch.train import detection as pdet
from tim_tpu_torch.train import recognition as prec
from tim_tpu_torch.utils import msgpack as pmsgpack

LR = 1e-3
REL_TOL = 1e-4
NUM_FEATS = 8
EXTRA = {"val_stats": {"loss": 1.25, "top1": 37.5}, "note": np.float32(0.5),
         "seen": np.int64(7), "tags": ["a", None, True, 3]}


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)),
        "f64": rng.normal(size=(2,)),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "i16": np.arange(-3, 4, dtype=np.int16),
        "i32": np.arange(3, dtype=np.int32),
        "i64": np.asarray([2 ** 40, -2 ** 50], np.int64),
        "u8": np.arange(200, 210, dtype=np.uint8),
        "bool": np.asarray([[True, False], [False, True]]),
        "zero_d": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-3),
                    "bool": np.bool_(True), "f64": np.float64(2.0),
                    "i32": np.int32(7), "u8": np.uint8(9)},
        "python": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536,
                            2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
                            -33, -128, -129, -2 ** 15, -2 ** 15 - 1,
                            -2 ** 31, -2 ** 31 - 1, -2 ** 63],
                   "float": 1.5, "short": "x" * 31, "str8": "y" * 32,
                   "str16": "z" * 300, "unicode": "naïve ø", "true": True,
                   "false": False, "none": None, "complex": complex(1.5, -2),
                   "bytes": b"abc", "long_bytes": bytes(range(256)) * 300},
        "list": [1, {"z": 1, "a": [2.5, None]}, "q", [], {}],
        "wide_map": {f"k{i}": i for i in range(20)},
        "long_list": list(range(70000)),
    }


def _assert_tree_equal(got, want, path="tree"):
    """The port's decode (tensors) against flax's (numpy), bit for bit."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor), (path, type(got))
        assert tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, np.generic):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_decode_equals_flax_leaf_for_leaf():
    blob = serialization.msgpack_serialize(_codec_tree())
    _assert_tree_equal(pmsgpack.msgpack_restore(blob),
                       serialization.msgpack_restore(blob))


def test_encode_equals_flax_byte_for_byte():
    tree = _codec_tree()
    blob = serialization.msgpack_serialize(tree)
    assert pmsgpack.msgpack_serialize(tree) == blob
    # the decoded tree (tensor leaves, bf16 included) encodes the same
    assert pmsgpack.msgpack_serialize(pmsgpack.msgpack_restore(blob)) == blob
    with pytest.raises(TypeError):
        pmsgpack.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(TypeError):
        serialization.msgpack_serialize({"t": (1, 2)})


def test_chunked_leaves_both_ways(monkeypatch):
    for mod in (serialization, pmsgpack):
        monkeypatch.setattr(mod, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(10, 7)).astype(np.float32),
            "inner": {"x": np.arange(100, dtype=np.int16),
                      "small": np.ones(3, np.float32)},
            "in_list": [np.zeros(50, np.float32)],
            "bf16": np.asarray(jnp.arange(90, dtype=jnp.bfloat16))}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert pmsgpack.msgpack_serialize(tree) == blob
    got = pmsgpack.msgpack_restore(blob)
    _assert_tree_equal(got, serialization.msgpack_restore(blob))
    assert pmsgpack.msgpack_serialize(got) == blob


def test_bad_files_raise_with_the_offset(tmp_path):
    blob = serialization.msgpack_serialize(_codec_tree())
    for bad in (blob[:-3], blob[:1], blob + b"\x00"):
        with pytest.raises(ValueError, match="offset"):
            pmsgpack.msgpack_restore(bad)
    import msgpack
    with pytest.raises(ValueError, match="unknown extension code 9"):
        pmsgpack.msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"xy")))
    odd = msgpack.packb(msgpack.ExtType(1, msgpack.packb(
        ((2,), "float128x", b"\0" * 32), use_bin_type=True)))
    with pytest.raises(ValueError, match="dtype name"):
        pmsgpack.msgpack_restore(odd)
    short = msgpack.packb(msgpack.ExtType(1, msgpack.packb(
        ((3,), "float32", b"\0" * 8), use_bin_type=True)))
    with pytest.raises(ValueError, match="data bytes"):
        pmsgpack.msgpack_restore(short)
    (tmp_path / "checkpoint.msgpack").write_bytes(blob[:100])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint(str(tmp_path))


def test_orbax_only_directory_is_read(tmp_path):
    """The directory ``tests/test_train.py``'s orbax test writes: the port
    falls back to its newest epoch, as JAX's ``load_checkpoint`` does, and
    reads JAX's payload leaf for leaf (the empty optax states as
    ``{}``)."""
    from tim_tpu.train.optim import make_optimizer
    from tim_tpu.train.state import create_train_state
    params = {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               make_optimizer(1e-3, 1e-4, 10, 2),
                               normaliser=2.0)
    jckpt.save_checkpoint_orbax(str(tmp_path), state, epoch=4)
    want = jckpt.load_checkpoint(str(tmp_path))
    got = ckpt.load_checkpoint(str(tmp_path))
    _assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, want))
    assert int(got["epoch"]) == 4
    assert got["opt_state"]["inner_state"]["0"] == {}


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _random_like(shapes, seed=0):
    """Seeded normal fp32 leaves shaped as ``shapes`` (a tree of
    ``ShapeDtypeStruct``)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _tim_param_shapes(cfg):
    """The flax param tree's shapes of a JAX TIM model of ``cfg`` (traced,
    not run)."""
    nf, key = cfg.num_feats, jax.random.PRNGKey(0)
    v = jnp.zeros((1, nf, cfg.visual_input_dim))
    a = jnp.zeros((1, nf, cfg.audio_input_dim))
    if isinstance(cfg, C.DetectionConfig):
        nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
        model, args = JaxTimDetection(cfg), (nq, nq)
        times = jnp.zeros((1, cfg.num_context + 2 * nq, 2))
    else:
        model, args = JaxTimRecognition(cfg), trec._queries(cfg)
        v, a, times = (None if x is None else jnp.asarray(x)
                       for x in trec.rec_inputs(cfg, b=1))
    return jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, v, a, times, *args,
        deterministic=True))["params"]


def _backbone_param_shapes(kind):
    from tim_tpu.extract.masking import TubeMasking, batch_mask_indices
    from tim_tpu.models.backbones.mae import PretrainVideoMAE
    from tim_tpu.models.backbones.vit import VideoMAEViT
    kw = dict(img_size=32, patch_size=8, embed_dim=16, depth=2, num_heads=2,
              num_frames=4, tubelet_size=2)
    x = jnp.zeros((1, 4, 32, 32, 3))
    key = jax.random.PRNGKey(0)
    if kind == "vit":
        return jax.eval_shape(lambda: VideoMAEViT(**kw).init(key, x))["params"]
    model = PretrainVideoMAE(**kw, decoder_dim=8, decoder_depth=2,
                             decoder_heads=2)
    vis, msk = batch_mask_indices(TubeMasking(model.grid, 0.5), 1,
                                  np.random.default_rng(0))
    return jax.eval_shape(lambda: model.init(
        key, x, jnp.asarray(vis), jnp.asarray(msk)))["params"]


@pytest.mark.parametrize("kind", ["detection", *trec.PRESETS, "vit", "mae"])
def test_params_to_jax_inverts_from_jax_exactly(kind):
    if kind == "detection":
        shapes = _tim_param_shapes(tdet._det_cfg())
        there = convert.detection_state_dict_from_jax
        back = convert.detection_params_to_jax
    elif kind in trec.PRESETS:
        shapes = _tim_param_shapes(trec.rec_cfgs(kind)[0])
        there = convert.recognition_state_dict_from_jax
        back = convert.recognition_params_to_jax
    else:
        shapes = _backbone_param_shapes(kind)
        there = (functools.partial(convert.vit_state_dict_from_jax, depth=2)
                 if kind == "vit" else convert.mae_state_dict_from_jax)
        back = (convert.vit_params_to_jax if kind == "vit"
                else convert.mae_params_to_jax)
    params = _random_like(shapes)
    got, want = _flat(back(there({"params": params}))), _flat(params)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
            name


# ---------------------------------------------------------------------------
# JAX -> the port -> JAX, through the runners
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bundle():
    return jsyn.synthetic_epic(seed=7, num_videos=2, video_seconds=40.0,
                               per_video=8, visual_dim=24, audio_dim=16,
                               visual_classes=(5, 6, 4), audio_classes=3)


def _splits(kind, data_mod, win_mod):
    b = _bundle() if win_mod is jwin else port_tables(_bundle())
    stores = (data_mod.FeatureStore(b["v_feats"], b["v_feat_times"]),
              data_mod.FeatureStore(b["a_feats"], b["a_feat_times"]))
    if kind == "detection":
        wsz = NUM_FEATS * 2 * 0.2
        ws = win_mod.build_detection_windows(
            win_mod.normalize_actions(b["v_actions"], "visual",
                                      detection=True, window_size=wsz),
            win_mod.normalize_actions(b["a_actions"], "audio",
                                      detection=True, window_size=wsz),
            b["video_info"], b["v_feat_times"], num_feats=NUM_FEATS,
            feat_stride=2, feat_gap=0.2)
        return [data_mod.DetectionDataset(
            ws, *stores, include_verb_noun=False, dataset_name="synthetic",
            sample_augmentations=False) for _ in range(2)]
    ws = win_mod.build_recognition_windows(
        win_mod.normalize_actions(b["v_actions"], "visual"),
        win_mod.normalize_actions(b["a_actions"], "audio"),
        b["video_info"], b["v_feat_times"], num_feats=NUM_FEATS,
        feat_stride=2, feat_gap=0.2)
    return [data_mod.RecognitionDataset(ws, *stores,
                                        sample_augmentations=False)
            for _ in range(2)]


def _configs(kind):
    widths = dict(visual_input_dim=24, audio_input_dim=16, d_model=16,
                  nhead=2, num_layers=2, num_feats=NUM_FEATS,
                  compute_dtype="float32", enc_dropout=0.0, feat_dropout=0.0,
                  seq_dropout=0.0)
    if kind == "detection":
        cfg = C.DetectionConfig(visual_classes=(4,), audio_classes=3,
                                train_query_size=0.1,
                                inference_query_size=0.2, **widths)
        tcfg = C.TrainConfig(batch_size=8, epochs=2, warmup_epochs=1, lr=LR,
                             lambda_drloc=0.1, normaliser_init=30.0, seed=0)
        return cfg, port_cfg(cfg), tcfg
    cfg = C.ModelConfig(visual_classes=(5, 6, 4), audio_classes=3, **widths)
    tcfg = C.TrainConfig(batch_size=8, epochs=2, warmup_epochs=1, lr=LR,
                         mixup_alpha=0.4, lambda_drloc=0.1, seed=0)
    return cfg, PC.ModelConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__}), tcfg


def _from_jax(kind):
    fn = (convert.detection_state_dict_from_jax if kind == "detection"
          else convert.recognition_state_dict_from_jax)
    return lambda tree: fn({"params": tree})


def _jax_record(kind, params, opt_state, step, normaliser):
    """Parameters and moments under the port's names, the four counters,
    step and normaliser of a JAX state (or a loaded JAX payload)."""
    sd = serialization.to_state_dict(opt_state)
    adam = sd["inner_state"]["1"]["0"]
    assert int(sd["inner_state"]["1"]["2"]["count"]) == int(adam["count"])
    conv = _from_jax(kind)
    return {"params": conv(params), "mu": conv(adam["mu"]),
            "nu": conv(adam["nu"]),
            "counters": {"count": int(adam["count"]),
                         "notfinite_count": int(sd["notfinite_count"]),
                         "total_notfinite": int(sd["total_notfinite"]),
                         "last_finite": bool(sd["last_finite"])},
            "step": int(step), "normaliser": float(normaliser)}


def _port_record(state):
    opt = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    return {"params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()},
            "mu": {names[i]: s["exp_avg"].clone()
                   for i, s in opt["state"].items()},
            "nu": {names[i]: s["exp_avg_sq"].clone()
                   for i, s in opt["state"].items()},
            "counters": {k: (bool(v) if v.dtype == torch.bool else int(v))
                         for k, v in opt["if_finite"].items()},
            "step": state.step, "normaliser": float(state.normaliser)}


def _assert_records_equal(got, want):
    for what in ("params", "mu", "nu"):
        assert sorted(got[what]) == sorted(want[what]), what
        for name, w in want[what].items():
            assert torch.equal(got[what][name], w), f"{what} {name}"
    for what in ("counters", "step", "normaliser"):
        assert got[what] == want[what], what


def _assert_records_close(got, want):
    """Within REL_TOL of each tensor's largest value; the k third of
    ``in_proj_bias`` (a gradient of 0 in exact arithmetic, so Adam steps
    it on rounding noise) within 2 lr."""
    for what in ("params", "mu", "nu"):
        assert sorted(got[what]) == sorted(want[what]), what
        for name, w in want[what].items():
            w = w.double().numpy()
            err = np.abs(got[what][name].double().numpy() - w)
            if name.endswith("self_attn.in_proj_bias"):
                c = len(w) // 3
                assert err[c:2 * c].max() <= 2 * LR, f"{what} {name} k"
                err, w = np.delete(err, np.s_[c:2 * c]), \
                    np.delete(w, np.s_[c:2 * c])
            assert err.max() <= REL_TOL * max(np.abs(w).max(), 1e-30), \
                f"{what} {name}: {err.max()} of {np.abs(w).max()}"
    assert got["counters"] == want["counters"]
    assert got["step"] == want["step"]
    np.testing.assert_allclose(got["normaliser"], want["normaliser"],
                               rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _round_trip(kind, tmp):
    """Both packages through four steps (JAX 2, save, port resume, both
    a third, port save, JAX resume, both a fourth); the records and files
    of every point."""
    cfg, pcfg, tcfg = _configs(kind)
    jtrain, jval = _splits(kind, jds, jwin)
    ptrain, pval = _splits(kind, pds, pwin)
    if kind == "detection":
        jrun = JaxDetectionRunner(cfg, tcfg, jtrain, jval,
                                  mesh_cfg=C.MeshConfig(data=1),
                                  use_device_bank=False)
        prun = DetectionRunner(pcfg, port_train_cfg(tcfg), ptrain, pval,
                               use_device_bank=False, device="cpu")
    else:
        jrun = JaxRecognitionRunner(cfg, tcfg, jtrain, jval,
                                    mesh_cfg=C.MeshConfig(data=1),
                                    dataset_name="epic",
                                    use_device_bank=False)
        prun = RecognitionRunner(pcfg, port_train_cfg(tcfg), ptrain, pval,
                                 use_device_bank=False, device="cpu")
    assert prun.steps_per_epoch == max(len(jtrain) // tcfg.batch_size, 1)
    batches = [{k: v for k, v in b.items() if not k.startswith("_")}
               for b in jds.batch_iterator(jtrain, tcfg.batch_size,
                                           shuffle=False)][:4]
    assert len(batches) == 4
    rng = jax.random.PRNGKey(5)
    if kind == "detection":
        nq = JQ.generate_query_pyramid(cfg.inference_query_size).shape[0]
        pstep = pdet.make_train_step(
            prun.model, pcfg, port_train_cfg(tcfg),
            draws=tdet._jax_draws(cfg, tcfg, rng, nq))
    else:
        pstep = prec.make_train_step(
            prun.model, pcfg, port_train_cfg(tcfg), prun.nv, prun.na,
            draws=trec.jax_draws(cfg, tcfg, rng))

    def jax_step(i):
        jrun.state, metrics = jrun._train_step(
            jrun.state, {k: jnp.asarray(v) for k, v in batches[i].items()},
            rng)
        return float(metrics["loss"])

    def port_step(i):
        metrics = pstep(prun.state, {k: torch.from_numpy(np.asarray(v))
                                     for k, v in batches[i].items()})
        return float(metrics["loss"])

    def jax_now():
        s = jrun.state
        return _jax_record(kind, s.params, s.opt_state, s.step, s.normaliser)

    dirs = {k: os.path.join(tmp, f"{kind}_{k}") for k in "ABC"}
    out = {"dirs": dirs}
    jrun.init_state()
    for i in range(2):
        jax_step(i)
    jckpt.save_checkpoint(dirs["A"], jrun.state, epoch=1, extra=EXTRA)
    payload = jckpt.load_checkpoint(dirs["A"])
    out["file_A"] = _jax_record(kind, payload["params"], payload["opt_state"],
                                payload["step"], payload["normaliser"])
    out["epoch_A"] = prun.resume(dirs["A"])
    out["port_A"] = _port_record(prun.state)
    port_payload = ckpt.load_checkpoint(dirs["A"])
    ckpt.save_jax_checkpoint(dirs["B"], prun.state,
                             epoch=port_payload["epoch"],
                             extra=port_payload["extra"])
    out["loss3"] = jax_step(2), port_step(2)
    out["jax3"], out["port3"] = jax_now(), _port_record(prun.state)
    ckpt.save_jax_checkpoint(dirs["C"], prun.state, epoch=2, extra=EXTRA,
                             is_best="loss_top1")
    out["epoch_C"] = jrun.resume(dirs["C"])
    out["jax_C"] = jax_now()
    out["loss4"] = jax_step(3), port_step(3)
    out["jax4"], out["port4"] = jax_now(), _port_record(prun.state)
    out["extra_C"] = jckpt.load_checkpoint(dirs["C"])["extra"]
    return out


@pytest.fixture(scope="module")
def round_trips(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("round_trips"))
    return lambda kind: _round_trip(kind, tmp)


KINDS = ["detection", "recognition"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_resumes_in_the_port_exactly(round_trips, kind):
    r = round_trips(kind)
    assert r["epoch_A"] == 1
    assert r["file_A"]["step"] == 2 and r["file_A"]["counters"]["count"] == 2
    _assert_records_equal(r["port_A"], r["file_A"])


@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_jax_file_back_byte_for_byte(round_trips, kind):
    dirs = round_trips(kind)["dirs"]
    with open(os.path.join(dirs["A"], "checkpoint.msgpack"), "rb") as f:
        want = f.read()
    with open(os.path.join(dirs["B"], "checkpoint.msgpack"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("kind", KINDS)
def test_a_step_after_the_resume_agrees_with_jax(round_trips, kind):
    r = round_trips(kind)
    np.testing.assert_allclose(r["loss3"][1], r["loss3"][0], rtol=REL_TOL)
    _assert_records_close(r["port3"], r["jax3"])
    assert r["port3"]["step"] == 3


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_resumes_in_jax(round_trips, kind):
    """``save_jax_checkpoint`` after the port's third step: JAX's
    ``resume`` holds exactly the port's state, and a fourth step on both
    sides agrees."""
    r = round_trips(kind)
    assert r["epoch_C"] == 2
    _assert_records_equal(r["port3"], r["jax_C"])
    np.testing.assert_allclose(r["loss4"][1], r["loss4"][0], rtol=REL_TOL)
    _assert_records_close(r["port4"], r["jax4"])
    assert sorted(r["extra_C"]) == sorted(EXTRA)
    assert type(r["extra_C"]["note"]) is np.float32
    files = {}
    for name in ("checkpoint", "best_loss", "best_top1"):
        with open(os.path.join(r["dirs"]["C"], f"{name}.msgpack"), "rb") as f:
            files[name] = f.read()
    assert files["best_loss"] == files["checkpoint"] == files["best_top1"]


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------

class _Warnings(logging.Handler):
    """The sorted warning messages of one logger (attached to it, so
    that a logger that does not propagate is heard too)."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.logger, self.messages = logging.getLogger(name), []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.messages.sort()


@pytest.mark.parametrize("kind", KINDS)
def test_pretrained_model_through_cli_run_merges_as_jax(kind, tmp_path,
                                                        monkeypatch):
    """A JAX file whose action head has another class count and which
    holds an entry the model lacks: ``cli.run --validate
    --pretrained_model`` loads every other entry as JAX's
    ``shape_matched_merge`` does, with the same warnings."""
    from tim_tpu.train.optim import make_optimizer
    from tim_tpu.train.state import create_train_state
    from tim_tpu_torch import cli
    cfg, pcfg, tcfg = _configs(kind)
    params = _random_like(_tim_param_shapes(cfg), seed=3)
    file_params = {**params,
                   "cls_head": {**params["cls_head"],
                                "fc_action": {"kernel": np.ones((32, 9),
                                                                np.float32),
                                              "bias": np.ones(9, np.float32)}},
                   "unused_head": {"kernel": np.ones((2, 2), np.float32)}}
    state = create_train_state(file_params, make_optimizer(LR, 0.0, 10, 1))
    jckpt.save_checkpoint(str(tmp_path / "jax"), state, epoch=3)
    with _Warnings("tim_tpu.train.checkpoint") as want:
        jckpt.shape_matched_merge(serialization.to_state_dict(params),
                                  jckpt.load_checkpoint(
                                      str(tmp_path / "jax"))["params"])
    assert len(want.messages) == 3, want.messages

    seen = {}
    merge = ckpt.jax_merge

    def recording(model, loaded):
        seen["model"] = model
        merged, seen["kept"] = merge(model, loaded)
        return merged, seen["kept"]

    argv = ["--output_dir", str(tmp_path / "out"), "--validate",
            "--pretrained_model", str(tmp_path / "jax"), "--num_feats",
            str(NUM_FEATS), "--feat_stride", "2", "--d_model", "16",
            "--nhead", "2", "--num_layers", "2", "--visual_input_dim", "24",
            "--audio_input_dim", "16", "--compute_dtype", "float32",
            "--batch-size", "8", "--seed", "0"]
    if kind == "detection":
        argv += ["--variant", "detection"]
    args = cli.build_parser().parse_args(argv)
    orig_configs = cli.configs_from_args
    monkeypatch.setattr(ckpt, "jax_merge", recording)
    monkeypatch.setattr(cli, "configs_from_args",
                        lambda a: (pcfg, *orig_configs(a)[1:]))
    with _Warnings("tim_tpu_torch.train.checkpoint") as got:
        stats = cli.run(args, *_splits(kind, pds, pwin), device="cpu")
    assert got.messages == want.messages
    assert all(np.isfinite(v) for v in stats.values())
    head = "cls_head.fc_visual_action"
    assert seen["kept"] == [f"{head}.weight", f"{head}.bias"]
    loaded = _from_jax(kind)(params)
    for name, t in seen["model"].state_dict().items():
        if not name.startswith(head):
            assert torch.equal(t, loaded[name]), name


def _frames(video_id, indices, offset):
    """Seeded uint8 frames [T, 48, 64, 3] of a segment."""
    return np.stack([np.random.default_rng([int(i), int(offset)])
                     .integers(0, 256, (48, 64, 3), np.uint8)
                     for i in indices])


def test_finetune_cli_warm_starts_from_a_jax_mae_file(tmp_path):
    """The JAX package's ``PretrainVideoMAE`` state (``save_checkpoint``
    of an ``optax.adamw`` state, as its ``--mode pretrain`` writes) read by
    the finetune CLI's ``--pretrained``: the encoder loads into the ViT
    trunk with JAX's warnings (``fc_norm`` missing, the decoder unused),
    and the CLI trains from it."""
    import optax
    from tim_tpu.models.backbones.vit import VideoMAEViT as JaxViT
    from tim_tpu.train.state import create_train_state
    from tim_tpu_torch.extract import finetune_cli as pcli
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    mae = _random_like(_backbone_param_shapes("mae"), seed=4)
    jckpt.save_checkpoint(str(tmp_path / "pre"), create_train_state(
        mae, optax.adamw(1.5e-4, weight_decay=0.05)), epoch=1)
    trunk_shapes = jax.eval_shape(lambda: JaxViT(
        img_size=32, patch_size=8, embed_dim=16, depth=2, num_heads=2,
        num_frames=4, tubelet_size=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3))))["params"]
    with _Warnings("tim_tpu.train.checkpoint") as want:
        jckpt.shape_matched_merge(
            _random_like(trunk_shapes),
            jckpt.load_checkpoint(str(tmp_path / "pre"))["params"])
    trunk = VideoMAEViT(img_size=32, patch_size=8, embed_dim=16, depth=2,
                        num_heads=2, num_frames=4, tubelet_size=2,
                        device="cpu")
    with _Warnings("tim_tpu_torch.train.checkpoint") as got:
        params, missing = pcli.load_pretrained_encoder(
            str(tmp_path / "pre"), trunk)
    assert got.messages == want.messages
    assert any("decoder_block1" in m for m in want.messages)
    assert missing == ["fc_norm.weight", "fc_norm.bias"]
    encoder = convert.mae_state_dict_from_jax({"params": mae})
    own = trunk.state_dict()
    for name, t in params.items():
        assert torch.equal(t, own[name] if name in missing
                           else encoder[name]), name

    args = pcli.build_parser().parse_args([
        "--mode", "finetune", "--anno_train", "unused.csv", "--data_path",
        "unused", "--output_dir", str(tmp_path / "ft"), "--input_size", "32",
        "--patch_size", "8", "--embed_dim", "16", "--depth", "2",
        "--num_heads", "2", "--num_frames", "4", "--tubelet_size", "2",
        "--num_verbs", "2", "--num_nouns", "2", "--epochs", "1",
        "--warmup_epochs", "0", "--batch_size", "2", "--num_sample", "1",
        "--compute_dtype", "float32", "--pretrained", str(tmp_path / "pre")])
    anno = {"video_id": np.asarray(["v1"] * 4),
            "start_frame": np.asarray([0, 10, 20, 30]),
            "stop_frame": np.asarray([25, 40, 50, 58]),
            "verb_class": np.asarray([0, 1, 0, 1]),
            "noun_class": np.asarray([1, 0, 1, 0])}
    train_ds, val_ds = pcli.datasets(args, anno, None, _frames,
                                     rand_augment=pcli.identity_augment)
    stats = pcli.run(args, train_ds, val_ds, device="cpu")
    assert sorted(stats) == ["noun_top1", "verb_top1"]


def test_mae_state_written_for_jax_restores_there_exactly(tmp_path):
    """``save_jax_checkpoint`` of a ``PretrainVideoMAE`` state (a
    ``torch.optim.AdamW`` after one step): JAX's ``restore_train_state``
    into an ``optax.adamw`` state holds its parameters, moments, count
    and step exactly."""
    import optax
    from tim_tpu.train.state import create_train_state
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
    ckpt.save_jax_checkpoint(str(tmp_path), state, epoch=1)
    jstate = create_train_state(_random_like(_backbone_param_shapes("mae")),
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
