"""The ported detection slice against the JAX package at fp32: the dense
inference step's outputs and ``DetectionServer.detect_video``'s detections.
The JAX side runs with ``use_fused_ffn=True``, so its Pallas fused kernel
runs in interpret mode on the CPU."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    inference_batch, jax_variables, port_cfg, port_model, small_cfg)
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.serve import DetectionServer as JaxDetectionServer
from tim_tpu.train.detection import make_inference_step as jax_inference_step
from tim_tpu_torch.convert import detection_state_dict_from_jax
from tim_tpu_torch.serve import DetectionServer
from tim_tpu_torch.train.detection import make_inference_step

ATOL = 1e-4   # fp32; sums run in another order than XLA's


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("top_k", [None, 3])
def test_inference_step_matches_jax(fused, top_k):
    cfg = small_cfg(use_fused_ffn=fused)
    variables = jax_variables(cfg)
    batch = inference_batch(cfg, batch=3)

    want = jax.jit(jax_inference_step(JaxTimDetection(cfg), cfg,
                                      top_k=top_k))(
        variables["params"], {k: jax.numpy.asarray(v)
                              for k, v in batch.items()})
    got = make_inference_step(port_model(cfg, variables), port_cfg(cfg),
                              top_k=top_k)(
        {k: torch.from_numpy(v) for k, v in batch.items()})

    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if key.endswith("_classes"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=key)


def _video(cfg, seed=0):
    duration = 20.0
    nfeat = 95
    starts = np.linspace(0, duration - 1.1, nfeat).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.1], -1)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(nfeat, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(nfeat, cfg.audio_input_dim)).astype(np.float32)
    return v, a, feat_times, duration


@pytest.mark.parametrize("top_k", [None, 4])
def test_detect_video_matches_jax(top_k):
    cfg = small_cfg(use_fused_ffn=True)
    variables = jax_variables(cfg)
    kw = dict(feat_stride=2, feat_gap=0.2, batch_size=4, top_k=top_k)
    want_server = JaxDetectionServer(cfg, variables["params"], **kw)
    got_server = DetectionServer(port_cfg(cfg),
                                 detection_state_dict_from_jax(variables),
                                 device="cpu", **kw)
    v, a, feat_times, duration = _video(cfg)

    want = want_server.detect_video(v, a, feat_times, duration,
                                    score_threshold=0.02)
    got = got_server.detect_video(v, a, feat_times, duration,
                                  score_threshold=0.02)
    assert len(want["scores"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)
    np.testing.assert_allclose(got["segments"], want["segments"], atol=ATOL)
