"""Checkpoint layout and the port's copies of jax-importing numpy helpers:
``detection_state_dict_from_jax`` inverts ``detection_params_from_torch``
and loads strictly; the query pyramid and the server's window helpers equal
the JAX package's; importing the port's serving module loads no jax."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import jax_variables, small_cfg
from tim_tpu.convert.torch_import import detection_params_from_torch
from tim_tpu.models.queries import generate_query_pyramid as jax_pyramid
from tim_tpu.serve import DetectionServer as JaxDetectionServer
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.serve import DetectionServer


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

    model = TimDetection(cfg)
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
    server = DetectionServer(cfg, detection_state_dict_from_jax(variables),
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


def test_serve_imports_no_jax():
    code = ("import sys; import tim_tpu_torch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
