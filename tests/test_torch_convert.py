"""Checkpoint layout and the port's copies of the JAX package's code:
``detection_state_dict_from_jax`` inverts ``detection_params_from_torch``
and loads strictly (recognition's: ``tests/test_torch_recognition.py``);
the config dataclasses and presets, the query pyramid, the window
helpers, thresholding and per-video Soft-NMS equal the JAX package's; the
port imports nothing of JAX or of the JAX package, and its entry points
default to the CUDA card."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import jax_variables, port_cfg, small_cfg
from tim_tpu import config as C
from tim_tpu.convert.torch_import import detection_params_from_torch
from tim_tpu.data.windows import window_feat_indices as jax_window_indices
from tim_tpu.evals import format_predictions as jax_fp
from tim_tpu.models.queries import generate_query_pyramid as jax_pyramid
from tim_tpu.serve import DetectionServer as JaxDetectionServer
from tim_tpu_torch import config as PC
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.data.windows import window_feat_indices
from tim_tpu_torch.evals import format_predictions as fp
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.serve import DetectionServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("classes", [(11,), (4, 5, 11)])
def test_state_dict_round_trip_and_strict_load(classes):
    cfg = small_cfg(visual_classes=classes)
    variables = jax_variables(cfg)
    sd = detection_state_dict_from_jax(variables)
    back = detection_params_from_torch(sd, d_model=cfg.d_model,
                                       num_layers=cfg.num_layers)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(path))

    model = TimDetection(port_cfg(cfg), device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())


@pytest.mark.parametrize("size", [0.005, 0.01, 0.2])
def test_query_pyramid_equals_jax(size):
    np.testing.assert_array_equal(generate_query_pyramid(size),
                                  jax_pyramid(size))


def test_window_helpers_equal_jax():
    cfg = small_cfg()
    variables = jax_variables(cfg)
    kw = dict(feat_stride=2, feat_gap=0.2, window_stride=0.7)
    jax_server = JaxDetectionServer(cfg, variables["params"], **kw)
    server = DetectionServer(port_cfg(cfg),
                             detection_state_dict_from_jax(variables),
                             device="cpu", **kw)
    nfeat = 61
    starts = np.linspace(0, 14.3, nfeat).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.1], -1)
    feats = np.random.default_rng(0).normal(size=(nfeat, 5)).astype(
        np.float32)
    for duration in (2.5, 15.2):
        ws = server._window_starts(duration)
        np.testing.assert_array_equal(ws, jax_server._window_starts(duration))
        for got, want in zip(
                server._assemble(feats, feat_times, ws, duration),
                jax_server._assemble(feats, feat_times, ws, duration)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ModelConfig", "DetectionConfig",
                                  "TrainConfig"])
def test_config_copy_equals_jax(name):
    """Same fields, order and defaults; ``TrainConfig`` leaves out exactly
    the JAX package's two TPU-only fields."""
    ours, theirs = getattr(PC, name), getattr(C, name)
    tpu_only = ({"xla_fusion_cost_model", "rng_impl"}
                if name == "TrainConfig" else set())
    assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
            == [(f.name, f.default) for f in dataclasses.fields(theirs)
                if f.name not in tpu_only])
    assert tpu_only <= {f.name for f in dataclasses.fields(theirs)}
    if name == "TrainConfig":
        return
    for preset in ("epic_detection", "perception_detection",
                   "epic_recognition", "epic_visual_only",
                   "perception_recognition", "ave_recognition"):
        assert (dataclasses.asdict(getattr(PC, preset)(num_layers=2))
                == dataclasses.asdict(getattr(C, preset)(num_layers=2)))
        assert (dataclasses.asdict(getattr(PC, preset)())
                == dataclasses.asdict(getattr(C, preset)()))
    cfg = PC.epic_detection()
    assert (cfg.encoder_width, cfg.num_context, cfg.vis_mul,
            cfg.seq_len(399, 399)) == (1024, 100, 1, 898)


@pytest.mark.parametrize("stride,nf", [(1, 8), (3, 50), (2, 100)])
def test_window_feat_indices_equal_jax(stride, nf):
    rng = np.random.default_rng(stride)
    starts = np.sort(rng.uniform(0, 40, 120)).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.0], -1)
    for ws in (-1.0, 0.0, 3.3, 17.0, 39.5):
        np.testing.assert_array_equal(
            window_feat_indices(feat_times, ws, ws + 30.0, stride, nf),
            jax_window_indices(feat_times, ws, ws + 30.0, stride, nf))


def _candidates(seed, n=300, classes=7):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 50, n)
    props = np.stack([start, start + rng.uniform(-0.5, 6, n)], -1)
    vids = np.asarray([f"v{i % 3}" for i in range(n)], object)
    scores = rng.uniform(0, 0.2, (n, classes)).astype(np.float32)
    return vids, props, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_thresholding_and_nms_equal_jax(seed):
    vids, props, scores = _candidates(seed)
    order = np.argsort(-scores, -1)[:, :3]
    topv = np.take_along_axis(scores, order, -1)
    for ours, theirs in (
            (fp.threshold_predictions(vids, props, scores, 0.05),
             jax_fp.threshold_predictions(vids, props, scores, 0.05)),
            (fp.threshold_predictions_topk(vids, props, topv, order, 0.05),
             jax_fp.threshold_predictions_topk(vids, props, topv, order,
                                               0.05))):
        assert sorted(ours) == sorted(theirs)
        for kind in ("soft", "hard"):
            got = fp.nms_per_video(ours, nms_kind=kind)
            want = jax_fp.nms_per_video(theirs, nms_kind=kind)
            for vid in want:
                for key in ("segments", "scores", "labels"):
                    np.testing.assert_array_equal(got[vid][key],
                                                  want[vid][key])


def _port_modules():
    pkg = os.path.join(ROOT, "tim_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_serve_imports_no_jax():
    """Importing every module of the port loads no module of JAX, flax,
    the JAX package (tim_tpu) or the tests."""
    modules = sorted(_port_modules())
    for module in ("ops.int8_matmul_fused", "ops.window_attention",
                   "ops.flash_mha", "models.backbones.swin3d",
                   "models.backbones.vit", "extract.pipeline",
                   "extract.cli", "models.backbones.mae", "extract.masking",
                   "train.backbone_finetune", "train.optim", "train.state",
                   "runner.backbone", "utils.logging", "ops.intervals",
                   "ops.losses", "ops.dropout", "data.dataset",
                   "data.device_bank", "data.synthetic", "train.checkpoint",
                   "train.detection", "evals.metrics", "evals.meters",
                   "runner.detection", "evals.anet", "evals.ek100",
                   "models.pool", "train.recognition", "runner.recognition",
                   "cli", "evals.__main__", "validate_checkpoint",
                   "models.backbones.slowfast", "extract.audio",
                   "extract.spec_warp", "extract.augment"):
        assert f"tim_tpu_torch.{module}" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tim_tpu', 'jax', 'jaxlib', 'flax', 'tests')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT)


@pytest.mark.parametrize("sd", [
    {"a.w": 1, "b": 2}, {"module.a.w": 1, "module.b": 2},
    {"module._orig_mod.a": 1, "module._orig_mod.b": 2},
    {"_orig_mod.module.a": 1}, {"module.a": 1, "b": 2}, {}])
def test_strip_wrapper_copy_equals_jax(sd):
    from tim_tpu.convert.torch_import import _strip_wrapper as jax_strip
    from tim_tpu_torch.convert import _strip_wrapper
    assert _strip_wrapper(sd) == jax_strip(sd)


def test_chip_smoke_imports_nothing_of_the_jax_package():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.findall(r"^\s*(from|import)\s+(tim_tpu|jax|flax)\b",
                          src, re.M)


def test_entry_points_default_to_the_card():
    """No device argument means the CUDA card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card (tests/test_torch_gpu.py "
                    "builds there)")
    cfg = port_cfg(small_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        TimDetection(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        DetectionServer(cfg, {})
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.serve import RecognitionServer
    rcfg = PC.epic_recognition(d_model=16, num_layers=1, nhead=2)
    with pytest.raises(RuntimeError, match="cuda"):
        TimRecognition(rcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        RecognitionServer(rcfg, {})
    with pytest.raises(RuntimeError, match="cuda"):
        RecognitionServer.quantized(rcfg, {}, [None])
    from tim_tpu_torch.extract.cli import build_parser, make_visual_apply
    from tim_tpu_torch.models.backbones import SwinTransformer3D, VideoMAEViT
    with pytest.raises(RuntimeError, match="cuda"):
        SwinTransformer3D()
    with pytest.raises(RuntimeError, match="cuda"):
        VideoMAEViT()
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    from tim_tpu_torch.runner.backbone import TwoHeadViT
    with pytest.raises(RuntimeError, match="cuda"):
        PretrainVideoMAE()
    with pytest.raises(RuntimeError, match="cuda"):
        TwoHeadViT(VideoMAEViT())
    for backbone in ("omnivore", "videomae"):
        with pytest.raises(RuntimeError, match="cuda"):
            make_visual_apply(build_parser().parse_args(
                ["--backbone", backbone, "--feature_times", "x",
                 "--out_dir", "y"]))


def test_masking_copy_equals_jax():
    """``extract/masking.py`` is a copy: every generator gives the JAX
    package's masks from the same numpy generator state."""
    from tim_tpu.extract import masking as jm
    from tim_tpu_torch.extract import masking as pm
    for name in ("RandomMasking", "TubeMasking",
                 "TemporalProgressiveMasking",
                 "TemporalCenteringProgressiveMasking"):
        ours, theirs = getattr(pm, name)((8, 14, 14), 0.9), \
            getattr(jm, name)((8, 14, 14), 0.9)
        for seed in (0, 1):
            np.testing.assert_array_equal(
                ours(np.random.default_rng(seed)),
                theirs(np.random.default_rng(seed)))
        got = pm.batch_mask_indices(ours, 3, np.random.default_rng(2))
        want = jm.batch_mask_indices(theirs, 3, np.random.default_rng(2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pm.TubeMasking((8, 14, 14), 0.9).total_masks == 8 * 176


def test_schedule_and_logging_copies_equal_jax(tmp_path):
    """``train/optim.py::warmup_cosine_schedule`` and the logging helpers
    are copies (the schedule in Python floats, JAX's in float32: 1e-5
    relative, a few float32 ulps at the 1e-6 floor)."""
    from tim_tpu.train.optim import warmup_cosine_schedule as jsched
    from tim_tpu.utils import logging as jlog
    from tim_tpu_torch.train.optim import warmup_cosine_schedule
    from tim_tpu_torch.utils import logging as plog
    ours, theirs = warmup_cosine_schedule(1e-3, 1e-6, 50, 5), \
        jsched(1e-3, 1e-6, 50, 5)
    np.testing.assert_allclose([ours(s) for s in range(60)],
                               [float(theirs(s)) for s in range(60)],
                               rtol=1e-5)
    assert plog.is_master() and jlog.is_master()
    for mod, name in ((plog, "port_copy"), (jlog, "jax_original")):
        logger = mod.setup_logging(str(tmp_path / name), name=f"t_{name}")
        assert mod.setup_logging(None, name=f"t_{name}") is logger
        mod.log_json_stats(logger, {"b": 2, "a": np.float32(0.5)})
        for h in logger.handlers:
            h.flush()
    lines = [(tmp_path / n / "stdout.log").read_text().split("] ", 1)[1]
             for n in ("port_copy", "jax_original")]
    assert lines[0] == lines[1] == 'json_stats: {"a": 0.5, "b": 2}\n'
