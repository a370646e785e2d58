"""Port modules against their flax counterparts at fp32, on the same params
(converted with ``detection_state_dict_from_jax``) and the same numpy
inputs: feature encoding, one encoder layer (fused and unfused, with and
without the layer-0 shared-query projection), both detection heads, the
time encoding, and structured vs dense-masked attention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    jax_variables, num_queries, port_model, small_cfg)
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models.encodings import FeatureEncoding as JaxFeatureEncoding
from tim_tpu.models.heads import (
    DetectionClsHead as JaxClsHead, DetectionRegHead as JaxRegHead)
from tim_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from tim_tpu.ops.attention import tim_attention as jax_tim_attention
from tim_tpu_torch.ops.attention import (
    dense_masked_attention, tim_attention, tim_attention_mask)

ATOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def _rng(seed=3):
    return np.random.default_rng(seed)


def test_time_encoding_matches_flax():
    cfg = small_cfg()
    variables = jax_variables(cfg)
    times = _rng().uniform(0, 1, size=(3, 7, 2)).astype(np.float32)
    want = JaxTimDetection(cfg).apply(variables, jnp.asarray(times),
                                      method=JaxTimDetection.encode_times)
    _close(port_model(cfg, variables).encode_times(torch.from_numpy(times)),
           want)


def test_feature_encoding_matches_flax():
    cfg = small_cfg()
    variables = jax_variables(cfg)
    nq = num_queries(cfg)
    rng = _rng()
    v = rng.normal(size=(2, cfg.num_feats, cfg.visual_input_dim))
    a = rng.normal(size=(2, cfg.num_feats, cfg.audio_input_dim))
    te = rng.normal(size=(2, cfg.num_context + 2 * nq, cfg.d_model))
    v, a, te = (x.astype(np.float32) for x in (v, a, te))

    want = JaxFeatureEncoding(
        d_model=cfg.d_model, input_modality=cfg.input_modality,
        data_modality=cfg.data_modality, num_feats=cfg.num_feats,
        use_verb_noun_cls=False).apply(
            {"params": variables["params"]["feature_encoding"]},
            jnp.asarray(v), jnp.asarray(a), jnp.asarray(te), nq, nq,
            deterministic=True)
    got = port_model(cfg, variables).feature_encoding(
        *(torch.from_numpy(x) for x in (v, a, te)), nq, nq)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_encoder_layer_matches_flax(fused, shared):
    cfg = small_cfg(use_fused_ffn=fused)
    variables = jax_variables(cfg)
    nq = num_queries(cfg)
    width = cfg.encoder_width
    rng = _rng()
    s = cfg.num_context + 2 * nq
    x = rng.normal(size=(3, s, width)).astype(np.float32)
    # dense inference: the query rows are identical across the batch
    x[1:, cfg.num_context:] = x[0, cfg.num_context:]

    want = JaxEncoderLayer(
        d_model=width, nhead=cfg.nhead,
        dim_feedforward=cfg.d_model * cfg.feedforward_scale,
        fused_ffn=fused).apply(
            {"params": variables["params"]["encoder"]["layer0"]},
            jnp.asarray(x), cfg.num_context, True, shared)
    layer = port_model(cfg, variables).backbone.layers[0]
    _close(layer(torch.from_numpy(x), cfg.num_context, shared), want)


def test_heads_match_flax():
    cfg = small_cfg()
    variables = jax_variables(cfg)
    p = variables["params"]
    nq = num_queries(cfg)
    width = cfg.encoder_width
    x = _rng().normal(size=(2, cfg.num_context + 2 * nq, width)).astype(
        np.float32)
    model = port_model(cfg, variables)

    want_cls = JaxClsHead(cfg.visual_classes, cfg.audio_classes).apply(
        {"params": p["cls_head"]}, jnp.asarray(x), nq, nq)
    want_reg = JaxRegHead(True, True, width).apply(
        {"params": p["reg_head"]}, jnp.asarray(x), nq, nq)
    got_cls = model.cls_head(torch.from_numpy(x), nq, nq)
    got_reg = model.reg_head(torch.from_numpy(x), nq, nq)
    for got, want in zip(got_cls + got_reg, tuple(want_cls) + tuple(want_reg)):
        assert (got is None) == (want is None)
        if want is not None:
            _close(got, want)


@pytest.mark.parametrize("num_ctx,nq", [(20, 0), (20, 7), (12, 36)])
def test_tim_attention_matches_jax_and_dense(num_ctx, nq):
    rng = _rng(0)
    q, k, v = (rng.normal(size=(2, 4, num_ctx + nq, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tim_attention(tq, tk, tv, num_ctx)
    _close(got, jax_tim_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), num_ctx))
    dense = dense_masked_attention(tq, tk, tv,
                                   tim_attention_mask(num_ctx + nq, num_ctx))
    torch.testing.assert_close(got, dense, atol=ATOL, rtol=ATOL)
