"""The port's command lines against the JAX package's on the CPU, fp32, on
the reference-format files of ``tests/test_cli.py``:

- ``python -m tim_tpu_torch.cli``: ``--validate`` and ``--extract_feats``
  of both variants with ``--torch_checkpoint`` on one saved port model:
  statistics and dumps within 1e-4 of the JAX CLI's; ``--train`` writes
  a checkpoint that ``--resume`` restores; the process grids that one
  process per card cannot lay out raise, ``--sequence_parallel`` runs;
  the parser, the configurations and the hidden defaults equal JAX's;
  without pandas the loader reads the pickles, names a global it refuses,
  and in a process where pandas, pyarrow, PIL, cv2, h5py and JAX cannot
  be imported ``main`` gives the JAX CLI's validation, ``cli.run``'s
  training on JAX-built windows and the JAX ``evals`` main's mAP;
- ``python -m tim_tpu_torch.evals`` against ``python -m tim_tpu.evals`` on
  one dump and GT pickle: equal submission JSON, mAP within 1e-6.
"""

import collections
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_cli import _common_args, disk_bundle  # noqa: F401
from tim_tpu import cli as jcli
from tim_tpu.evals.__main__ import main as jax_evals_main
from tim_tpu_torch import cli as pcli
from tim_tpu_torch.evals.__main__ import main as port_evals_main
from tim_tpu_torch.models import TimDetection, TimRecognition

# the tiny label space of tests/test_cli.py's bundle
CLASSES = {"recognition": dict(visual_classes=(5, 6, 4), audio_classes=3),
           "detection": dict(visual_classes=(5,), audio_classes=3,
                             train_query_size=0.1,
                             inference_query_size=0.2)}
TOL = 1e-4


def _variant_args(variant):
    return [] if variant == "recognition" else ["--variant", "detection"]


def _patch_configs(mp):
    """Both CLIs' configurations with the bundle's class counts, as
    ``tests/test_cli.py`` patches the JAX CLI's."""
    for mod in (jcli, pcli):
        def patched(args, _orig=mod.configs_from_args):
            mcfg, *rest = _orig(args)
            return (dataclasses.replace(mcfg, **CLASSES[args.variant]),
                    *rest)
        mp.setattr(mod, "configs_from_args", patched)


@pytest.fixture
def tiny_configs(monkeypatch):
    _patch_configs(monkeypatch)


@pytest.fixture(scope="module")
def checkpoints(disk_bundle, tmp_path_factory):  # noqa: F811
    """One saved port model a variant, in the reference's format; the
    detection regression heads' two sigmoids biased apart, so that its
    proposals have length and the evaluation has candidates."""
    out = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for variant, cls in (("recognition", TimRecognition),
                         ("detection", TimDetection)):
        args = pcli.build_parser().parse_args(
            _common_args(disk_bundle, out) + _variant_args(variant))
        cfg = dataclasses.replace(pcli.configs_from_args(args)[0],
                                  **CLASSES[variant])
        model = cls(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
        sd = model.state_dict()
        for k in sd:
            if k.startswith("reg_head.") and k.endswith(".4.bias"):
                sd[k] = torch.tensor([-1.0, 1.0])
        paths[variant] = out / f"{variant}.pyth"
        torch.save({"state_dict": sd, "epoch": 4}, paths[variant])
    return paths


def _capture_jax_validate(monkeypatch):
    from tim_tpu import runner as jrunner
    got = {}
    for cls in (jrunner.DetectionRunner, jrunner.RecognitionRunner):
        orig = cls.validate

        def validate(self, *a, _orig=orig, **kw):
            got["stats"] = _orig(self, *a, **kw)
            return got["stats"]

        monkeypatch.setattr(cls, "validate", validate)
    return got


@pytest.fixture(scope="module")
def jax_validate_stats(disk_bundle, checkpoints,  # noqa: F811
                       tmp_path_factory):
    """``variant -> the JAX CLI's --validate statistics`` with the
    variant's saved model, each computed once for the module."""
    cache = {}

    def stats(variant):
        if variant not in cache:
            mp = pytest.MonkeyPatch()
            try:
                _patch_configs(mp)
                got = _capture_jax_validate(mp)
                jcli.main(_common_args(disk_bundle,
                                       tmp_path_factory.mktemp("jax"))
                          + _variant_args(variant)
                          + ["--torch_checkpoint", str(checkpoints[variant]),
                             "--validate"])
                cache[variant] = got["stats"]
            finally:
                mp.undo()
        return cache[variant]

    return stats


def _stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("variant", ["recognition", "detection"])
def test_validate_matches_jax(variant, disk_bundle, checkpoints,  # noqa: F811
                              jax_validate_stats, tiny_configs, tmp_path,
                              capsys):
    argv = (_common_args(disk_bundle, tmp_path) + _variant_args(variant)
            + ["--torch_checkpoint", str(checkpoints[variant]),
               "--validate"])
    want = jax_validate_stats(variant)
    got = pcli.main(argv, device="cpu")
    capsys.readouterr()
    _stats_close(got, want)


def test_extract_feats_recognition_matches_jax(
        disk_bundle, checkpoints, tiny_configs, tmp_path):  # noqa: F811
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", pcli.main, {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        main(_common_args(disk_bundle, out)
             + ["--torch_checkpoint", str(checkpoints["recognition"]),
                "--extract_feats"], **kw)
        with open(out / "val_features.pkl", "rb") as f:
            outs[name] = pickle.load(f)
    got, want = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want)
    for k in ("v_narration_ids", "a_narration_ids"):
        assert list(got[k]) == list(want[k])
    for k in ("action", "verb", "noun", "audio"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def detection_dumps(disk_bundle, checkpoints, tmp_path_factory):  # noqa: F811
    """Both CLIs' dense ``--extract_feats`` dumps of the detection model,
    and the port's top-2 dump: {name: path}."""
    mp = pytest.MonkeyPatch()
    _patch_configs(mp)
    paths = {}
    try:
        for name, main, kw, extra in (
                ("jax", jcli.main, {}, []),
                ("port", pcli.main, {"device": "cpu"}, []),
                ("port_top2", pcli.main, {"device": "cpu"},
                 ["--extract_top_k", "2"])):
            out = tmp_path_factory.mktemp(name)
            main(_common_args(disk_bundle, out) + _variant_args("detection")
                 + ["--torch_checkpoint", str(checkpoints["detection"]),
                    "--extract_feats"] + extra, **kw)
            paths[name] = out / "dense_predictions.npz"
    finally:
        mp.undo()
    return paths


def test_extract_feats_detection_matches_jax(detection_dumps):
    with np.load(detection_dumps["jax"], allow_pickle=True) as f:
        want = {k: f[k] for k in f.files}
    with np.load(detection_dumps["port"], allow_pickle=True) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    assert list(got["video_ids"]) == list(want["video_ids"])
    for k in ("queries", "v_proposals", "a_proposals", "action", "audio"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
    with np.load(detection_dumps["port_top2"], allow_pickle=True) as f:
        top = {k: f[k] for k in f.files}
    assert "action" not in top and top["action_topk_values"].shape[-1] == 2
    np.testing.assert_allclose(top["action_topk_values"][:, 0],
                               np.sort(got["action"], -1)[:, -1], atol=1e-6)


@pytest.mark.parametrize("variant", ["recognition", "detection"])
def test_train_writes_a_checkpoint_that_resume_restores(
        variant, disk_bundle, tiny_configs, tmp_path, capsys):  # noqa: F811
    """One epoch of ``--train`` writes ``checkpoint.pt``; ``--resume`` from
    it and ``--validate`` gives the final epoch's validation statistics
    again (the same weights)."""
    base = _common_args(disk_bundle, tmp_path) + _variant_args(variant)
    stats = pcli.main(base + ["--train", "--finetune_epochs", "1",
                              "--warmup_epochs", "0"], device="cpu")
    assert os.path.exists(tmp_path / "checkpoint.pt")
    payload = torch.load(tmp_path / "checkpoint.pt", weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] > 0
    again = pcli.main(base + ["--resume", str(tmp_path), "--validate"],
                      device="cpu")
    capsys.readouterr()
    assert sorted(again) == sorted(stats)
    for k in stats:
        assert np.isfinite(stats[k]), k
        np.testing.assert_allclose(again[k], stats[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("flags", [
    ["--mesh_data", "3"], ["--num_shards", "2", "--shard_id", "2"],
    ["--mesh_model", "2"], ["--sequence_parallel", "true"]])
def test_multi_gpu_flags_raise(flags, disk_bundle, checkpoints,  # noqa: F811
                               tiny_configs, tmp_path, capsys):
    """The process grids that one process per card cannot lay out raise
    ``ValueError``: a data axis other than -1 or ``--num_shards /
    --mesh_model``, a shard id outside ``[0, num_shards)``, a model axis
    that does not divide ``--num_shards`` (here 1). ``--sequence_parallel
    true`` runs: in one process (no model axis) ``--validate`` gives the
    statistics of the run without it. (``--num_shards 2 --mesh_model 2``
    with and without sequence parallelism run over two ranks:
    ``tests/test_torch_tensor_parallel.py``.)"""
    if flags[0] != "--sequence_parallel":
        with pytest.raises(ValueError, match="one process per card|shard_id|"
                           "does not divide"):
            pcli.main(["--validate", "--output_dir", str(tmp_path)] + flags,
                      device="cpu")
        return
    argv = (_common_args(disk_bundle, tmp_path)
            + ["--torch_checkpoint", str(checkpoints["recognition"]),
               "--validate"])
    want = pcli.main(argv, device="cpu")
    got = pcli.main(argv + flags, device="cpu")
    capsys.readouterr()
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert got[k] == want[k], k


def test_parser_has_the_jax_flags():
    def flags(parser):
        return sorted((a.dest, a.default, tuple(a.choices or ()))
                      for a in parser._actions)
    assert flags(pcli.build_parser()) == flags(jcli.build_parser())


@pytest.mark.parametrize("argv", [
    [], ["--variant", "detection"],
    ["--variant", "detection", "--verb_only", "false"],
    ["--variant", "detection", "--include_verb_noun", "true"],
    ["--dataset", "perception", "--weight_decay", "0.01"],
    ["--variant", "detection", "--dataset", "ave", "--num_layers", "2",
     "--visual_input_dim", "512", "--model_modality", "visual"],
])
def test_configs_equal_jax(argv):
    """The presets and hidden defaults (visual width, depth, weight
    decay, EPIC detection heads) come out as the JAX CLI's."""
    mcfg, tcfg = pcli.configs_from_args(pcli.build_parser().parse_args(argv))
    jm, jt, _ = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    assert type(mcfg).__name__ == type(jm).__name__
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(jm)
    theirs = dataclasses.asdict(jt)
    assert all(theirs[k] == v for k, v in dataclasses.asdict(tcfg).items())


def test_without_pandas_the_loader_names_it(disk_bundle, tmp_path,  # noqa: F811
                                            monkeypatch):
    """Without pandas, ``main`` reads the reference's pickles with the
    port's own reader, which refuses a pickle holding a global outside its
    whitelist and names the global."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    bad = tmp_path / "video_info.pkl"
    with open(bad, "wb") as f:
        pickle.dump(collections.OrderedDict(duration=[40.0]), f)
    with pytest.raises(pickle.UnpicklingError,
                       match="collections.OrderedDict"):
        pcli.main(_common_args(disk_bundle, tmp_path)
                  + ["--validate", "--video_info_pickle", str(bad)],
                  device="cpu")


# Runs the port's command lines where pandas, pyarrow, PIL, cv2, h5py and
# JAX cannot be imported (the port needs none of them): argv[1] is a JSON
# spec of the runs; prints their results and the packages loaded.
NO_PANDAS_RUN = """
import dataclasses, json, sys
for name in ("pandas", "pyarrow", "PIL", "cv2", "h5py", "jax"):
    sys.modules[name] = None
from tim_tpu_torch import cli
from tim_tpu_torch.evals.__main__ import main as evals_main
spec = json.loads(sys.argv[1])

def patched(args, _orig=cli.configs_from_args):
    mcfg, *rest = _orig(args)
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in spec["classes"].items()}
    return (dataclasses.replace(mcfg, **kw), *rest)

cli.configs_from_args = patched
out = {run: {k: float(v) for k, v in cli.main(argv, device="cpu").items()}
       for run, argv in spec["cli"].items()}
if spec["evals"]:
    out["evals"] = evals_main(spec["evals"])
loaded = sorted(m for m in ("pandas", "pyarrow", "jax", "tim_tpu")
                if sys.modules.get(m) is not None)
print(json.dumps({"out": out, "loaded": loaded}))
"""


def _jax_built_splits(args, detection):
    """``cli.load_datasets``'s splits, their windows built by the JAX
    package from pandas's reading of the same pickles."""
    import pandas as pd
    from tim_tpu.data import windows as jwin
    from tim_tpu_torch.data import dataset as pds
    from tim_tpu_torch.data.table import Table
    wsz = args.num_feats * args.feat_gap * args.feat_stride
    info = pd.read_pickle(args.video_info_pickle)
    mcfg, _ = pcli.configs_from_args(args)

    def split(name, v_pkl, a_pkl, v_ctx, a_ctx, sample_aug):
        v, a = (jwin.normalize_actions(pd.read_pickle(p), m, args.dataset,
                                       detection=detection, window_size=wsz)
                for p, m in ((v_pkl, "visual"), (a_pkl, "audio")))
        stores = [pds.FeatureStore.from_npy_dir(
            str(root), name, Table.from_frame(pd.read_pickle(ctx)))
            for root, ctx in ((args.video_data_path, v_ctx),
                              (args.audio_data_path, a_ctx))]
        build = (jwin.build_detection_windows if detection
                 else jwin.build_recognition_windows)
        ws = build(v, a, info, stores[0].feat_times,
                   num_feats=args.num_feats, feat_stride=args.feat_stride,
                   feat_gap=args.feat_gap, window_stride=args.window_stride)
        if detection:
            return pds.DetectionDataset(
                ws, *stores, sample_augmentations=sample_aug,
                verb_only=args.verb_only,
                include_verb_noun=mcfg.include_verb_noun,
                dataset_name=args.dataset)
        return pds.RecognitionDataset(ws, *stores,
                                      sample_augmentations=sample_aug)

    return (split("train", args.video_train_action_pickle,
                  args.audio_train_action_pickle,
                  args.video_train_context_pickle,
                  args.audio_train_context_pickle, True),
            split("val", args.video_val_action_pickle,
                  args.audio_val_action_pickle,
                  args.video_val_context_pickle,
                  args.audio_val_context_pickle, False))


@pytest.mark.parametrize("variant", ["recognition", "detection"])
def test_main_without_pandas_matches_jax(
        variant, disk_bundle, checkpoints, detection_dumps,  # noqa: F811
        jax_validate_stats, tiny_configs, tmp_path, capsys):
    """In a process where pandas, pyarrow, PIL, cv2, h5py and JAX cannot
    be imported: ``cli.main --validate`` gives the JAX CLI's statistics
    within 1e-4; ``--train`` (one epoch) ``--validate`` gives those of
    ``cli.run`` on splits whose windows the JAX package built from
    pandas's reading of the same pickles, within 1e-4; and the ``evals``
    main on the detection dump gives the JAX one's mAP within 1e-6.
    Neither pandas, pyarrow, JAX nor ``tim_tpu`` is loaded."""
    base = (_common_args(disk_bundle, tmp_path) + _variant_args(variant)
            + ["--torch_checkpoint", str(checkpoints[variant])])
    train = base + ["--train", "--validate", "--finetune_epochs", "1",
                    "--warmup_epochs", "0"]
    evals = ([] if variant == "recognition" else [
        "--dump", str(detection_dumps["port"]),
        "--gt", str(disk_bundle / "v_actions.pkl"), "--task", "verb",
        "--score_threshold", "0.005"])
    spec = {"classes": CLASSES[variant], "evals": evals,
            "cli": {"validate": base + ["--validate"], "train": train}}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", NO_PANDAS_RUN, json.dumps(spec)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []

    _stats_close(got["out"]["validate"], jax_validate_stats(variant))
    args = pcli.build_parser().parse_args(train)
    ref = pcli.run(args, *_jax_built_splits(args, variant == "detection"),
                   device="cpu")
    _stats_close(got["out"]["train"], ref)
    if evals:
        theirs = jax_evals_main(evals)
        ours = got["out"]["evals"]
        np.testing.assert_allclose(ours["mAP"], theirs["mAP"], rtol=0,
                                   atol=1e-6)
        assert abs(ours["avg_mAP"] - theirs["avg_mAP"]) <= 1e-6
    capsys.readouterr()


def test_cli_defaults_to_the_card(disk_bundle, tmp_path):  # noqa: F811
    """Without a card, ``main`` raises before it reads any file (no
    pickle is given here)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.main(["--validate", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.run(pcli.build_parser().parse_args(
            _common_args(disk_bundle, tmp_path) + ["--validate"]),
            None, None)


@pytest.mark.parametrize("task,gt,dataset", [
    ("verb", "v_actions.pkl", "epic"),
    ("audio", "a_actions.pkl", "epic_sounds")])
def test_evals_main_matches_jax(task, gt, dataset, detection_dumps,
                                disk_bundle, tmp_path, capsys):  # noqa: F811
    """Both ``evals`` mains on the port CLI's dump: equal submission JSON
    and mAP within 1e-6."""
    results, subs = {}, {}
    for name, main in (("jax", jax_evals_main), ("port", port_evals_main)):
        sub = tmp_path / f"{name}.json"
        results[name] = main([
            "--dump", str(detection_dumps["port"]),
            "--gt", str(disk_bundle / gt), "--task", task,
            "--dataset", dataset, "--score_threshold", "0.005",
            "--submission", str(sub)])
        with open(sub) as f:
            subs[name] = json.load(f)
    capsys.readouterr()
    assert subs["port"] == subs["jax"]
    assert sum(len(v) for v in subs["port"]["results"].values()) > 0
    got, want = results["port"], results["jax"]
    assert got["task"] == want["task"] and got["tiou"] == want["tiou"]
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=0, atol=1e-6)
    assert abs(got["avg_mAP"] - want["avg_mAP"]) <= 1e-6
