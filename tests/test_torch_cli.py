"""The port's command lines against the JAX package's on the CPU, fp32, on
the reference-format files of ``tests/test_cli.py``:

- ``python -m tim_tpu_torch.cli``: ``--validate`` and ``--extract_feats``
  of both variants with ``--torch_checkpoint`` on one saved port model:
  statistics and dumps within 1e-4 of the JAX CLI's; ``--train`` writes
  a checkpoint that ``--resume`` restores; the multi-GPU flags raise;
  the parser, the configurations and the hidden defaults equal JAX's;
  without pandas the loader names it;
- ``python -m tim_tpu_torch.evals`` against ``python -m tim_tpu.evals`` on
  one dump and GT pickle: equal submission JSON, mAP within 1e-6.
"""

import dataclasses
import json
import os
import pickle
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


def _stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("variant", ["recognition", "detection"])
def test_validate_matches_jax(variant, disk_bundle, checkpoints,  # noqa: F811
                              tiny_configs, monkeypatch, tmp_path, capsys):
    argv = (_common_args(disk_bundle, tmp_path) + _variant_args(variant)
            + ["--torch_checkpoint", str(checkpoints[variant]),
               "--validate"])
    want = _capture_jax_validate(monkeypatch)
    jcli.main(argv)
    got = pcli.main(argv, device="cpu")
    capsys.readouterr()
    _stats_close(got, want["stats"])


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
    ["--num_shards", "2"], ["--mesh_data", "2"], ["--mesh_model", "2"],
    ["--sequence_parallel", "true"]])
def test_multi_gpu_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        pcli.main(["--validate", "--output_dir", str(tmp_path)] + flags,
                  device="cpu")


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


def test_without_pandas_the_loader_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        pcli.main(["--validate", "--output_dir", str(tmp_path)],
                  device="cpu")


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
