"""Int8 serving of the port against the JAX package at small sizes
(d_model 32, 2 layers), on the same seeded numpy inputs: weight
quantization (bit-equal), the dynamic and static int8 matmuls, kernel 3's
plain version against the Pallas kernel in interpret mode, the calibrated
activation scales of ``DetectionServer.quantized``, one quantized encoder
layer (packed q/k/v, with and without the layer-0 shared-query
projection), and the quantized inference step and ``detect_video`` with
and without the fused heads and bf16 scores.

Tolerances: the int8 products sum exactly on both sides, so quantized
outputs differ only where float32 roundings differ (XLA may fold a
division into a reciprocal multiply; kernel 3 multiplies by 1/s_x where
JAX on the CPU, which takes the XLA path, divides), which can move one
activation by one int8 step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    inference_batch, jax_variables, num_queries, port_cfg, small_cfg)
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from tim_tpu.ops.attention import tim_attention as jax_tim_attention
from tim_tpu.ops import quant as jquant
from tim_tpu.ops.pallas_int8 import int8_matmul_fused as jax_int8_fused
from tim_tpu.serve import DetectionServer as JaxDetectionServer
from tim_tpu.train.detection import make_inference_step as jax_inference_step
from tim_tpu_torch.convert import (
    act_scales_from_jax, detection_state_dict_from_jax,
    quantized_detection_state_dict_from_jax)
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.ops import quant
from tim_tpu_torch.ops.attention import tim_attention
from tim_tpu_torch.ops.int8_matmul_fused import (
    int8_matmul_fused, int8_matmul_fused_plain)
from tim_tpu_torch.serve import DetectionServer
from tim_tpu_torch.train.detection import make_inference_step

MATMUL_ATOL = 1e-5
# fp32 slice: a one-step flip of one activation moves a logit by about
# s_x * w_scale * |w_q| ~ 1e-3 at these sizes; scores and proposals pass
# through a sigmoid (slope <= 1/4). Measured: 1.5e-8 / 4.8e-7.
SLICE_ATOL = 1e-3
# bf16 scores: XLA may keep excess precision between its bf16 ops (it
# rounds scores, maxima and differences, not every exp and quotient);
# the port rounds every op to bf16 as written. Attention weights then
# differ by up to 2^-8 relative. Measured on these sizes: sigmoid scores
# 5.2e-4, proposals 3.0e-3 s (windows of 3.6 s): 4x and 3x margins.
FAST_SCORE_ATOL = 2e-3
FAST_PROPOSAL_ATOL = 1e-2
# ... and near-tied candidates can swap around the score threshold and in
# Soft-NMS, so with bf16 scores detect_video is held to its best
# detections: each of JAX's best FAST_TOP has a counterpart (label,
# segment) among the port's best 2 * FAST_TOP, its score within
# FAST_SCORE_ATOL.
FAST_TOP = 10


def _rng(seed=0):
    return np.random.default_rng(seed)


def _weights(k, n, seed=0):
    w = (_rng(seed).normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    w_q, scale = jquant.quantize_kernel(w)
    return w, w_q, scale, torch.from_numpy(np.ascontiguousarray(w_q.T)), \
        torch.from_numpy(scale)


@pytest.mark.parametrize("k,n", [(64, 19), (1024, 44), (2048, 37)])
def test_quantize_kernel_bit_equal(k, n):
    w, w_q, scale, _, _ = _weights(k, n)
    got_q, got_scale = quant.quantize_kernel(w)
    assert got_q.dtype == np.int8 and got_scale.dtype == np.float32
    np.testing.assert_array_equal(got_q, w_q)
    np.testing.assert_array_equal(got_scale, scale)


@pytest.mark.parametrize("pallas_heads", [False, True])
def test_quantized_state_dict_bit_equal(pallas_heads):
    cfg = small_cfg()
    variables = jax_variables(cfg)
    got = quant.quantize_state_dict(detection_state_dict_from_jax(variables))
    want = quantized_detection_state_dict_from_jax(
        jquant.quantize_params(variables["params"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    assert any(k.endswith("self_attn.in_proj.weight_q") for k in got)
    qcfg = port_cfg(dataclasses.replace(cfg, quantized_inference=True,
                                        quant_pallas_heads=pallas_heads))
    TimDetection(qcfg, device="cpu").load_state_dict(got, strict=True)


@pytest.mark.parametrize("k", [64, 2048])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_matmul_matches_jax(mode, k):
    _, w_q, scale, tw, tscale = _weights(k, 23, seed=k)
    x = _rng(1).normal(size=(2, 19, k)).astype(np.float32)
    if mode == "dynamic":
        want = jax.jit(jquant.int8_matmul)(x, w_q, scale)
        got = quant.int8_matmul(torch.from_numpy(x), tw, tscale)
    else:
        sx = float(np.float32(np.abs(x).max() / 127.0))
        want = jax.jit(lambda a, b, c: jquant.int8_matmul_static(
            a, b, c, sx))(x, w_q, scale)
        got = quant.int8_matmul_static(torch.from_numpy(x), tw, tscale, sx)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MATMUL_ATOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,activation", [(False, None), (True, None),
                                             (True, "gelu")])
def test_fused_plain_matches_pallas(out_dtype, bias, activation):
    """Ragged M (37 rows) and N (44) against the Pallas kernel in
    interpret mode with 16-row and 32-column blocks."""
    _, w_q, scale, tw, tscale = _weights(64, 44, seed=3)
    rng = _rng(2)
    x = rng.normal(size=(37, 64)).astype(np.float32)
    b = (rng.normal(size=44) * 0.1).astype(np.float32) if bias else None
    sx = float(np.float32(np.abs(x).max() / 127.0))
    want = jax_int8_fused(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), sx,
        bias=None if b is None else jnp.asarray(b), activation=activation,
        block_m=16, block_n=32, out_dtype=jnp.dtype(out_dtype),
        interpret=True)
    tdt = getattr(torch, out_dtype)
    got = int8_matmul_fused(torch.from_numpy(x), tw, tscale, sx,
                            None if b is None else torch.from_numpy(b),
                            activation, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == want.shape
    # identical int8 operands and int32 sums; fp32: erf implementations,
    # bf16: one output rounding of that
    tol = {"float32": 1e-6, "bfloat16": 1e-2}[out_dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _quantize_edge_rows(m, k, sx, seed):
    """[m, k] fp32 rows at kernel 3's quantize edges for the scale sx (a
    power of two, so x / sx is exact): values that land on j + 0.5 (round
    half to even), on both sides of +-127.5 and far past it (saturation),
    and normal values between."""
    rng = _rng(seed)
    halves = (rng.integers(-140, 140, size=(m, k)) + 0.5) * sx
    normal = rng.normal(size=(m, k)) * 40 * sx
    x = np.where(rng.random((m, k)) < 0.5, halves, normal)
    x[0, : min(k, 6)] = np.array([126.5, 127.5, 128.5, -127.5, -128.5,
                                  1e4])[: min(k, 6)] * sx
    return x.astype(np.float32)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(16, 44), (48, 44), (16, 3806),
                                 (48, 3806)])
def test_fused_plain_quantize_edges_match_pallas(out_dtype, k, n):
    """Kernel 3's quantization at its edges, the plain version against the
    Pallas kernel in interpret mode: half-integer multiples of s_x (round
    half to even), values past +-127 s_x (saturation to +-127), K 16 and 48
    (the card's k32 steps half filled with zeros), N 44 (fc_audio) and 3806
    (fc_action). The int8 sums are exact on both sides; a value rounded the
    other way moves an output by s_x * w_scale * |w_q|, far past the
    tolerance."""
    _, w_q, scale, tw, tscale = _weights(k, n, seed=k + n)
    sx = 2.0 ** -4
    x = _quantize_edge_rows(21, k, sx, seed=k)
    b = (_rng(7).normal(size=n) * 0.1).astype(np.float32)
    want = jax_int8_fused(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), sx,
        bias=jnp.asarray(b), block_m=16, out_dtype=jnp.dtype(out_dtype),
        interpret=True)
    tdt = getattr(torch, out_dtype)
    got = int8_matmul_fused(torch.from_numpy(x), tw, tscale, sx,
                            torch.from_numpy(b), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == want.shape
    tol = {"float32": 1e-6, "bfloat16": 1e-2}[out_dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("k,ok", [(2048, True), (2064, False), (40, False)])
def test_fused_check_takes_the_kernels_k(k, ok):
    """The card's kernel keeps a tile of quantized rows in shared memory:
    K a multiple of 16 up to 2048 runs in one launch on w_q as it is
    (``ok``); longer K in chunks of 2048 and other K on w_q zero-padded to
    a multiple of 16 (the launch plan). The wrapper's check takes every K,
    with w_q unpadded or padded, and refuses a w_q of another width
    (checked here on CPU tensors, which themselves take the plain
    version)."""
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    x = torch.zeros(2, 5, k)
    w_q = torch.zeros(24, k, dtype=torch.int8)
    args = (x, w_q, torch.ones(24), None, None, torch.bfloat16)
    i8._check(*args)
    i8._check(x, i8.pad_weight(w_q), *args[2:])
    assert (i8.launch_plan(k) == (1, k)) == ok
    with pytest.raises(ValueError, match="w_q must be int8"):
        i8._check(x, torch.zeros(24, k + 32, dtype=torch.int8), *args[2:])


def test_fused_reads_strided_views():
    """A [B, rows, K] slice of a wider sequence (the heads' query rows)
    gives what its contiguous copy gives."""
    _, _, _, tw, tscale = _weights(32, 12, seed=4)
    seq = torch.from_numpy(_rng(5).normal(size=(3, 20, 32)).astype(
        np.float32))
    view = seq[:, 7:16]
    got = int8_matmul_fused(view, tw, tscale, 0.02, out_dtype=torch.float32)
    want = int8_matmul_fused_plain(view.contiguous(), tw, tscale, 0.02,
                                   out_dtype=torch.float32)
    assert got.shape == (3, 9, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_scores_attention_matches_jax(dtype):
    """bf16 scores and softmax against JAX's ``score_dtype=bfloat16``
    einsum path on unit-variance q/k/v: XLA keeps excess precision where
    the port rounds each op, so attention weights differ by up to 2^-8
    relative; measured 1.1e-2 (fp32 compute) and 1.6e-2, one bf16 spacing
    at 2-4 (bf16 compute)."""
    rng = _rng(0)
    q, k, v = (rng.normal(size=(2, 4, 50, 16)).astype(np.float32)
               for _ in range(3))
    want = jax.jit(lambda a, b, c: jax_tim_attention(
        a, b, c, 12, score_dtype=jnp.bfloat16))(
            *(jnp.asarray(a, dtype) for a in (q, k, v)))
    got = tim_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in (q, k, v)), 12, fast_scores=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def _qparams(cfg):
    return jquant.quantize_params(jax_variables(cfg)["params"])


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_quantized_encoder_layer_matches_flax(static, shared):
    """Packed q/k/v int8 projection == JAX's separate q/k/v ones, per-row
    dynamic or one static scale, with and without layer 0's shared-query
    projection."""
    cfg = small_cfg()
    nq = num_queries(cfg)
    width = cfg.encoder_width
    s = cfg.num_context + 2 * nq
    x = _rng(3).normal(size=(3, s, width)).astype(np.float32)
    x[1:, cfg.num_context:] = x[0, cfg.num_context:]
    names = ("self_attn/q", "self_attn/k", "self_attn/v", "self_attn/out",
             "linear1", "linear2")
    scales = tuple((n, 0.02 + 0.001 * i) for i, n in enumerate(names))
    if static:   # q/k/v share their input, so one scale
        scales = tuple((n, 0.02 if n[-2:] in ("/q", "/k", "/v") else v)
                       for n, v in scales)
    qparams = _qparams(cfg)
    want = JaxEncoderLayer(
        d_model=width, nhead=cfg.nhead,
        dim_feedforward=cfg.d_model * cfg.feedforward_scale,
        quantized=True, quant_static_acts=static,
        act_scales=scales if static else ()).apply(
            {"params": qparams["encoder"]["layer0"]}, jnp.asarray(x),
            cfg.num_context, True, shared)

    qcfg = dataclasses.replace(cfg, quantized_inference=True)
    if static:
        port_scales = act_scales_from_jax(
            tuple((f"encoder/layer{i}/{n}", v) for i in range(2)
                  for n, v in scales) + (("cls_head/fc_action", 0.03),
                                         ("cls_head/fc_audio", 0.03)))
        qcfg = dataclasses.replace(qcfg, quant_static_acts=True,
                                   quant_act_scales=port_scales)
    model = TimDetection(port_cfg(qcfg), device="cpu")
    model.load_state_dict(quantized_detection_state_dict_from_jax(qparams),
                          strict=True)
    with torch.inference_mode():
        got = model.backbone.layers[0](torch.from_numpy(x), cfg.num_context,
                                       shared)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MATMUL_ATOL)


def test_static_scales_must_be_complete():
    cfg = port_cfg(small_cfg(quantized_inference=True,
                             quant_static_acts=True,
                             quant_act_scales=(("cls_head.fc_visual_action",
                                                0.1),)))
    with pytest.raises(ValueError, match="no static activation scale"):
        TimDetection(cfg, device="cpu")


def test_act_scales_from_jax_rejects_unequal_qkv():
    scales = (("encoder/layer0/self_attn/k", 0.2),
              ("encoder/layer0/self_attn/q", 0.1))
    with pytest.raises(ValueError, match="differ"):
        act_scales_from_jax(scales)


def _servers(cfg, batches, **kw):
    variables = jax_variables(cfg)
    jax_server = JaxDetectionServer.quantized(
        cfg, variables["params"], batches, **kw)
    port_batches = [None if b is None else
                    {k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches]
    server = DetectionServer.quantized(
        port_cfg(cfg), detection_state_dict_from_jax(variables),
        port_batches, device="cpu", **kw)
    return jax_server, server


@pytest.mark.parametrize("calibration", ["zero", "data"])
def test_calibrated_scales_match_jax(calibration):
    cfg = small_cfg()
    batches = ([None] if calibration == "zero"
               else [inference_batch(cfg, 2), inference_batch(cfg, 3, 7)])
    jax_server, server = _servers(cfg, batches)
    want = act_scales_from_jax(jax_server.cfg.quant_act_scales)
    got = server.cfg.quant_act_scales
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6)
    assert server.cfg.quant_static_acts and server.cfg.quantized_inference


def _quant_cfg(pallas_heads, fast_scores):
    return small_cfg(quant_pallas_heads=pallas_heads, fast_scores=fast_scores)


def _atol(key, fast_scores):
    if not fast_scores:
        return SLICE_ATOL
    return FAST_PROPOSAL_ATOL if "proposals" in key else FAST_SCORE_ATOL


@pytest.mark.parametrize("fast_scores", [False, True])
@pytest.mark.parametrize("pallas_heads", [False, True])
def test_quantized_inference_step_matches_jax(pallas_heads, fast_scores):
    """Top-3 dump in fp32 scores; dense scores with bf16 scores, whose
    near-tied classes may swap ranks."""
    cfg = _quant_cfg(pallas_heads, fast_scores)
    top_k = None if fast_scores else 3
    jax_server, server = _servers(cfg, [inference_batch(cfg, 2)],
                                  top_k=top_k)
    batch = inference_batch(cfg, batch=3, seed=5)
    want = jax.jit(jax_inference_step(JaxTimDetection(jax_server.cfg),
                                      jax_server.cfg, top_k=top_k))(
        jax_server.params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_inference_step(server.model, server.cfg, top_k=top_k)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if key.endswith("_classes"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=_atol(key, fast_scores),
                                       err_msg=key)


def _video(cfg, seed=0):
    duration, nfeat = 20.0, 95
    starts = np.linspace(0, duration - 1.1, nfeat).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.1], -1)
    rng = _rng(seed)
    v = rng.normal(size=(nfeat, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(nfeat, cfg.audio_input_dim)).astype(np.float32)
    return v, a, feat_times, duration


@pytest.mark.parametrize("fast_scores", [False, True])
@pytest.mark.parametrize("pallas_heads", [False, True])
def test_quantized_detect_video_matches_jax(pallas_heads, fast_scores):
    cfg = _quant_cfg(pallas_heads, fast_scores)
    kw = dict(feat_stride=2, feat_gap=0.2, batch_size=4, top_k=4)
    jax_server, server = _servers(cfg, [inference_batch(cfg, 2)], **kw)
    v, a, feat_times, duration = _video(cfg)
    want = jax_server.detect_video(v, a, feat_times, duration,
                                   score_threshold=0.02)
    got = server.detect_video(v, a, feat_times, duration,
                              score_threshold=0.02)
    assert len(want["scores"]) > 2 * FAST_TOP
    if fast_scores:
        for i in range(FAST_TOP):
            top = slice(0, 2 * FAST_TOP)
            hit = np.flatnonzero(
                (got["labels"][top] == want["labels"][i])
                & (np.abs(got["segments"][top] - want["segments"][i]).max(1)
                   <= FAST_PROPOSAL_ATOL))
            assert len(hit) == 1, (i, want["labels"][i], want["segments"][i])
            assert abs(got["scores"][hit[0]] - want["scores"][i]) \
                <= FAST_SCORE_ATOL
        return
    # near-equal scores (Soft-NMS leaves many) may sort either way: compare
    # in (label, segment) order
    want, got = _by_label_segment(want), _by_label_segment(got)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SLICE_ATOL)
    np.testing.assert_allclose(got["segments"], want["segments"],
                               atol=SLICE_ATOL)


def _by_label_segment(dets):
    order = np.lexsort((dets["segments"][:, 1], dets["segments"][:, 0],
                        dets["labels"]))
    return {k: v[order] for k, v in dets.items()}
