"""The port at the widths the command lines take beyond the presets, against
the JAX package on the CPU:

- TIM detection inference in fp32 at two tiny widths: head dim 40 (which
  the card's attention kernels take zero-padded to an instance), and head
  dim 13 with C = 52 and FF = 104 (no multiple of 8, 16 or 128 anywhere):
  within 1e-4 of the largest value of each output;
- int8 static serving with K = C = 40, not a multiple of 16: int8 weights
  bit-equal, calibrated scales within 1e-6 relative, outputs within 1e-3
  (``tests/test_torch_quant.py``'s slice tolerance);
- a ``TwoHeadViT`` at head dim 20: 3 LLRD steps against JAX's, every
  parameter within 1e-4 of its largest value (``assert_state_close``'s
  Adam budget for elements whose gradient is rounding noise);
- the wrappers' launch plans (instance head dims, padded copies, the
  kernel-1 design, the tail's and the int8 head's paddings and chunks) and
  their checks, which take every new shape and still refuse mismatched
  shapes and dtypes;
- ``n_jobs > 1`` of the mAP chain without joblib: equal to ``n_jobs = 1``
  and to JAX's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _labels, assert_state_close
from tests.torch_port_helpers import (
    inference_batch, jax_variables, perturbed, port_cfg, port_model,
    small_cfg)
from tim_tpu.evals import anet as janet
from tim_tpu.evals import format_predictions as jfp
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models.backbones import vit as jvit
from tim_tpu.ops import quant as jquant
from tim_tpu.runner import backbone as jrunner
from tim_tpu.serve import DetectionServer as JaxDetectionServer
from tim_tpu.train import backbone_finetune as jft
from tim_tpu.train.detection import make_inference_step as jax_inference_step
from tim_tpu.train.state import create_train_state
from tim_tpu_torch.convert import (
    act_scales_from_jax, detection_state_dict_from_jax,
    quantized_detection_state_dict_from_jax, two_head_state_dict_from_jax)
from tim_tpu_torch.evals import anet as panet
from tim_tpu_torch.evals import format_predictions as pfp
from tim_tpu_torch.models.backbones import vit as pvit
from tim_tpu_torch.ops import flash_mha as fm
from tim_tpu_torch.ops import fused_post_attention as fpa
from tim_tpu_torch.ops import int8_matmul_fused as i8
from tim_tpu_torch.ops import quant
from tim_tpu_torch.ops import query_block_attention as qba
from tim_tpu_torch.runner import backbone as prunner
from tim_tpu_torch.serve import DetectionServer
from tim_tpu_torch.train import backbone_finetune as pft
from tim_tpu_torch.train.detection import make_inference_step
from tim_tpu_torch.train.state import TrainState

TOL = 1e-4          # fp32, of each output's largest value
INT8_ATOL = 1e-3    # int8 slice (tests/test_torch_quant.py's SLICE_ATOL)
GRAD_TOL = 1e-4     # parameters after Adam steps, of each largest

# (d_model, nhead): head dim 40, C 80, FF 160; head dim 13, C 52, FF 104
WIDTHS = {"padded-head": (40, 2), "odd": (26, 4)}


def _cfg(d_model, nhead, **kw):
    return small_cfg(d_model=d_model, nhead=nhead, **kw)


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def width(request):
    """(cfg, JAX variables, the JAX step's outputs on a batch of 3)."""
    cfg = _cfg(*WIDTHS[request.param], use_fused_ffn=True)
    variables = jax_variables(cfg)
    batch = inference_batch(cfg, batch=3)
    want = jax.jit(jax_inference_step(JaxTimDetection(cfg), cfg))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, variables, batch, {k: np.asarray(v) for k, v in want.items()}


def test_inference_at_new_widths_matches_jax(width):
    cfg, variables, batch, want = width
    got = make_inference_step(port_model(cfg, variables), port_cfg(cfg))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape, key
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= TOL * scale, key


@pytest.fixture(scope="module")
def int8_servers():
    """JAX's and the port's int8 static servers (fused heads) at K = C =
    40, calibrated on the same batch."""
    cfg = _cfg(20, 4, quant_pallas_heads=True)
    variables = jax_variables(cfg)
    batches = [inference_batch(cfg, 2)]
    jax_server = JaxDetectionServer.quantized(cfg, variables["params"],
                                              batches)
    server = DetectionServer.quantized(
        port_cfg(cfg), detection_state_dict_from_jax(variables),
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
        device="cpu")
    return cfg, variables, jax_server, server


def test_int8_weights_at_k_off_16_bit_equal(int8_servers):
    cfg, variables, _, _ = int8_servers
    assert cfg.encoder_width % 16
    got = quant.quantize_state_dict(detection_state_dict_from_jax(variables))
    want = quantized_detection_state_dict_from_jax(
        jquant.quantize_params(variables["params"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    k = got["cls_head.fc_visual_action.weight_q"].shape[1]
    assert k == cfg.encoder_width


def test_int8_static_serving_at_k_off_16_matches_jax(int8_servers):
    cfg, _, jax_server, server = int8_servers
    want_scales = act_scales_from_jax(jax_server.cfg.quant_act_scales)
    got_scales = server.cfg.quant_act_scales
    assert [n for n, _ in got_scales] == [n for n, _ in want_scales]
    np.testing.assert_allclose([s for _, s in got_scales],
                               [s for _, s in want_scales], rtol=1e-6)
    batch = inference_batch(cfg, batch=3, seed=5)
    want = jax.jit(jax_inference_step(JaxTimDetection(jax_server.cfg),
                                      jax_server.cfg))(
        jax_server.params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_inference_step(server.model, server.cfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, atol=INT8_ATOL, err_msg=key)
    # the kernel's padded weight: bit-equal on the first K columns, zeros
    # past them (made for the card; on the CPU the layer keeps its own)
    head = server.model.cls_head.fc_visual_action
    padded = i8.pad_weight(head.weight_q)
    assert padded.shape[1] == i8.padded_k(head.weight_q.shape[1])
    assert torch.equal(padded[:, :head.weight_q.shape[1]], head.weight_q)
    assert not padded[:, head.weight_q.shape[1]:].any()
    assert head.kernel_weight() is head.weight_q


VIT_HD20 = dict(img_size=24, patch_size=8, embed_dim=40, depth=2,
                num_heads=2, num_frames=4, tubelet_size=2)


def test_two_head_vit_at_head_dim_20_steps_match_jax():
    """3 steps of ``make_two_head_step`` + ``make_llrd_optimizer`` at head
    dim 20 (the card takes it on the 64 instance, zero-padded)."""
    jmodel = jrunner.TwoHeadViT(trunk=jvit.VideoMAEViT(**VIT_HD20),
                                num_verbs=5, num_nouns=7)
    clip = np.random.default_rng(4).normal(
        size=(2, 4, 24, 24, 3)).astype(np.float32)
    variables = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(clip)), 0)
    model = prunner.TwoHeadViT(pvit.VideoMAEViT(**VIT_HD20, device="cpu"),
                               num_verbs=5, num_nouns=7)
    model.load_state_dict(two_head_state_dict_from_jax(variables),
                          strict=True)
    assert fm.launch_plan(VIT_HD20["embed_dim"] // VIT_HD20["num_heads"],
                          torch.bfloat16) == (64, True)
    batch = {"video": clip, "verb": _labels(2)[0], "noun": _labels(2)[1]}
    kw = dict(depth=2, lr=1e-3, total_steps=3, warmup_steps=2)
    state = create_train_state(variables["params"], jft.make_llrd_optimizer(
        variables["params"], **kw))
    step = jax.jit(jrunner.make_two_head_step(jmodel, mixup_alpha=0.0))
    optimizer, schedule = pft.make_llrd_optimizer(model, **kw)
    pstate = TrainState(model, optimizer, schedule)
    pstep = prunner.make_two_head_step(model, mixup_alpha=0.0)
    pbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    for i in range(3):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rng)
        pmetrics = pstep(pstate, pbatch)
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        assert_state_close(dict(model.named_parameters()),
                           two_head_state_dict_from_jax(
                               {"params": state.params}),
                           GRAD_TOL, "param", 2e-3 * (i + 1))
    assert pstate.step == 3


BF16, F32 = torch.bfloat16, torch.float32


# (head dim, dtype, instance, whether q/k/v are copied): bf16 past 64 up to
# 128 runs on dh rounded up to 16 and reads multiples of 8 in place; fp32
# keeps the instances 64, 128 and 256
@pytest.mark.parametrize("dh,dtype,width,copied", [
    (1, BF16, 64, True), (64, BF16, 64, False), (65, BF16, 80, True),
    (72, BF16, 80, False), (80, BF16, 80, False), (88, BF16, 96, False),
    (91, BF16, 96, True), (96, BF16, 96, False), (104, BF16, 112, False),
    (112, BF16, 112, False), (120, BF16, 128, False),
    (127, BF16, 128, True), (128, BF16, 128, False), (129, BF16, 256, True),
    (160, BF16, 256, True), (256, BF16, 256, False), (1, F32, 64, True),
    (64, F32, 64, False), (80, F32, 128, True), (88, F32, 128, True),
    (128, F32, 128, False), (200, F32, 256, True), (256, F32, 256, False)])
def test_flash_instance_per_head_dim(dh, dtype, width, copied):
    assert fm.instance_dim(dh, dtype) == width
    assert fm.launch_plan(dh, dtype) == (width, copied)
    assert (width in fm.HEAD_DIMS if dtype == BF16
            else width in fm.F32_HEAD_DIMS)


def test_flash_plan_over_every_head_dim():
    """Head dims 1-256 in both dtypes: one instance each, the least that
    holds dh (bf16 65-128 in steps of 16); no copy exactly where dh is the
    instance's or, in bf16 on 80-128, a multiple of 8 within 16 below it."""
    for dtype in (BF16, F32):
        built = fm.HEAD_DIMS if dtype == BF16 else fm.F32_HEAD_DIMS
        for dh in range(1, 257):
            w, copied = fm.launch_plan(dh, dtype)
            assert w == min(x for x in built if x >= dh), (dh, dtype)
            in_place = dh == w or (dtype == BF16 and 80 <= w <= 128
                                   and dh % 8 == 0)
            assert copied == (not in_place), (dh, dtype)


def test_flash_plan_copies_rows_it_cannot_read_and_checks_shapes():
    q = torch.zeros(2, 3, 5, 64)
    assert fm.launch_plan(64, q.dtype, q, q, q) == (64, False)
    ragged = torch.zeros(2, 3, 5, 66)[..., :64]
    shifted = torch.zeros(2 * 3 * 5 * 64 + 1)[1:].view(2, 3, 5, 64)
    for bad in (ragged, shifted):
        assert fm.launch_plan(64, q.dtype, q, bad, q) == (64, True)
    # bf16 rows of 80 read in place on the 80 instance, unless a row is
    # not 16-byte aligned (a packed qkv of head dim 80 with a 4-element
    # shift, or rows of 84 elements)
    q80 = torch.zeros(2, 3, 5, 80, dtype=BF16)
    assert fm.launch_plan(80, BF16, q80, q80, q80) == (80, False)
    packed = torch.zeros(2 * 5 * 3 * 3 * 80 + 4, dtype=BF16)[4:].view(
        2, 5, 3, 3, 80)
    assert fm.launch_plan(80, BF16, *fm.unpack_qkv(packed)) == (80, True)
    rows84 = torch.zeros(2, 3, 5, 84, dtype=BF16)[..., :80]
    assert fm.launch_plan(80, BF16, q80, rows84, q80) == (80, True)
    # past 256 the column-slice route: 257 through the copy to 320
    assert fm.instance_dim(257, BF16) == 320
    for dh in (1, 80, 91, 256, 257):
        t = torch.zeros(1, 2, 3, dh)
        fm.check_args("flash_mha", t, t, t)
        for dtype in (torch.float32, torch.bfloat16):
            fm.check_args("flash_mha", t.to(dtype), t.to(dtype), t.to(dtype))
    t = torch.zeros(1, 2, 3, 80)
    with pytest.raises(ValueError, match="head dim"):
        fm.check_args("flash_mha", *(torch.zeros(1, 2, 3, 0),) * 3)
    with pytest.raises(ValueError, match="shape"):
        fm.check_args("flash_mha", t, torch.zeros(1, 2, 4, 80), t)
    with pytest.raises(ValueError, match="dtype"):
        fm.check_args("flash_mha", *(t.half(),) * 3)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        fm.check_args("flash_mha", t, t.bfloat16(), t)


def test_flash_routes_name_each_launch():
    """The route a launch counts on: one name per (dtype, instance,
    direction), with the copy marked."""
    assert fm.route(BF16, 80, False) == "wgmma 80"
    assert fm.route(BF16, 96, True) == "wgmma 96 via copy"
    assert fm.route(BF16, 80, False, backward=True) == "wgmma two passes 80"
    assert fm.route(BF16, 64, False, backward=True) == "wgmma one pass 64"
    assert fm.route(BF16, 64, False, backward=True, deterministic=True) \
        == "wgmma one pass 64 + dq pass"
    assert fm.route(BF16, 256, True, backward=True) \
        == "wgmma split passes 256 via copy"
    assert fm.route(F32, 128, True) == "fp32 cuda cores 128 via copy"
    # past 512 the bf16 forward's slices run as one cluster
    assert fm.route(BF16, 768, False) == "wgmma cluster slices 768"
    names = {fm.route(BF16, w, c, backward=b) for w in fm.HEAD_DIMS
             for c in (False, True) for b in (False, True)}
    assert len(names) == 4 * len(fm.HEAD_DIMS)


def test_flash_padded_copy_is_zero_past_the_head_dim():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 5, 80, generator=gen) for _ in range(3))
    buf = fm.padded_qkv(q, k, v, 128)
    assert buf.shape == (2, 5, 3, 3, 128) and buf.is_contiguous()
    for t, got in zip((q, k, v), fm.unpack_qkv(buf)):
        assert torch.equal(got[..., :80], t)
        assert not got[..., 80:].any()
    # zero columns change no score and give zero output columns
    pq, pk, pv = fm.unpack_qkv(buf)
    out = fm.flash_mha_plain(pq, pk, pv, sm_scale=80 ** -0.5)
    torch.testing.assert_close(
        out[..., :80], fm.flash_mha_plain(q, k, v, sm_scale=80 ** -0.5),
        rtol=0, atol=1e-6)
    assert not out[..., 80:].any()


@pytest.mark.parametrize("dh,aligned,plan", [
    (32, True, qba.TENSOR_CORES), (64, True, qba.TENSOR_CORES),
    (128, True, qba.TENSOR_CORES), (160, True, qba.TENSOR_CORES),
    (256, True, qba.COLS), (91, True, qba.TENSOR_CORES),
    (96, True, qba.TENSOR_CORES), (160, False, qba.TENSOR_CORES)])
def test_query_block_plan_and_check_take_every_head_dim(dh, aligned, plan):
    b, h, nq, f = 1, 2, 24, 10
    qkv = torch.zeros(b, nq + f, 3, h, dh + (0 if aligned else 1),
                      dtype=torch.bfloat16)[..., :dh]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    args = (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])
    qba._check(*args)
    assert qba.launch_plan(dh, torch.bfloat16) == plan
    assert qba.launch_plan(dh, torch.float32) == qba.CUDA_CORES


def test_query_block_check_still_refuses():
    t = torch.zeros(1, 2, 4, 91)
    c = torch.zeros(1, 2, 3, 91)
    # every head dim from 1 up is taken (257: the column-slice route); 0
    # is the one refused
    big, big_c = torch.zeros(1, 2, 4, 257), torch.zeros(1, 2, 3, 257)
    qba._check(big, big_c, big, big_c, big)
    assert qba.launch_plan(257, torch.bfloat16) == qba.COLS
    with pytest.raises(ValueError, match="head dim"):
        empty, empty_c = torch.zeros(1, 2, 4, 0), torch.zeros(1, 2, 3, 0)
        qba._check(empty, empty_c, empty, empty_c, empty)
    with pytest.raises(ValueError, match="shape"):
        qba._check(t, c, t, torch.zeros(1, 2, 3, 90), t)
    with pytest.raises(ValueError, match="dtype"):
        qba._check(*(x.half() for x in (t, c, t, c, t)))
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        qba._check(t, c.bfloat16(), t, c, t)


@pytest.mark.parametrize("c,ff,dtype,want", [
    (1024, 2048, torch.bfloat16, (1024, 2048)),
    (2560, 5120, torch.bfloat16, (2560, 5120)),
    (728, 1456, torch.bfloat16, (728, 1456)),
    (726, 1452, torch.bfloat16, (728, 1456)),
    (52, 104, torch.bfloat16, (56, 104)),
    (726, 1452, torch.float32, (726, 1452))])
def test_tail_plan_pads_bf16_rows_to_eight(c, ff, dtype, want):
    assert fpa.launch_plan(c, ff, dtype) == want


def _tail_args(c, ff, dtype=torch.float32):
    gen = torch.Generator().manual_seed(c)
    return (torch.randn(2, 3, c, generator=gen).to(dtype),
            torch.randn(2, 3, c, generator=gen).to(dtype),
            torch.ones(c), torch.zeros(c), torch.randn(ff, c, generator=gen),
            torch.zeros(ff), torch.randn(c, ff, generator=gen),
            torch.zeros(c), torch.ones(c), torch.zeros(c))


@pytest.mark.parametrize("c,ff", [(2560, 64), (52, 104), (726, 24)])
def test_tail_check_takes_any_width_and_refuses_mismatches(c, ff):
    for dtype in (torch.float32, torch.bfloat16):
        fpa._check(*_tail_args(c, ff, dtype))
    args = list(_tail_args(c, ff))
    bad_w = list(args)
    bad_w[4] = torch.zeros(ff, c + 1)
    with pytest.raises(ValueError, match="do not fit"):
        fpa._check(*bad_w)
    with pytest.raises(ValueError, match="dtype"):
        fpa._check(*[a.half() if i < 2 else a for i, a in enumerate(args)])
    bad_b = list(args)
    bad_b[5] = torch.zeros(ff + 1)
    with pytest.raises(ValueError, match="b1 has shape"):
        fpa._check(*bad_b)


def test_tail_padding_is_exact_in_the_plain_arithmetic():
    """What the bf16 route computes on a zero-padded row (LayerNorms over
    the true C, zero weights, biases and LN parameters past it) equals the
    unpadded tail on the first C columns."""
    c, ff = 13, 21
    args = _tail_args(c, ff)
    cp, ffp = 16, 24
    x, attn, g1, be1, w1, b1, w2, b2, g2, be2 = args
    y = fpa.layer_norm_fp32(x + attn, g1, be1)
    y_pad = torch.cat([y, torch.zeros(2, 3, cp - c)], -1)
    h = torch.nn.functional.gelu(
        y_pad @ fpa._pad(w1, ffp, cp).t() + fpa._pad(b1, ffp))
    o = h @ fpa._pad(w2, cp, ffp).t() + fpa._pad(b2, cp)
    z = fpa.layer_norm_fp32((y_pad + o)[..., :c], g2, be2)
    assert not (y_pad + o)[..., c:].any()
    torch.testing.assert_close(z, fpa.fused_post_attention_plain(*args),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,plan", [(16, (1, 16)), (40, (1, 48)),
                                    (728, (1, 736)), (1024, (1, 1024)),
                                    (2048, (1, 2048)), (2560, (2, 2560)),
                                    (4097, (3, 4112))])
def test_int8_plan_chunks_k_and_pads_w(k, plan):
    assert i8.launch_plan(k) == plan
    w = torch.randint(-127, 128, (5, k), dtype=torch.int8)
    p = i8.pad_weight(w)
    assert p.shape == (5, plan[1])
    assert torch.equal(p[:, :k], w) and not p[:, k:].any()
    x = torch.zeros(2, 3, k)
    for wq in (w, p):
        i8._check(x, wq, torch.ones(5), None, None, torch.bfloat16)
    with pytest.raises(ValueError, match="w_q must be int8"):
        i8._check(x, w.float(), torch.ones(5), None, None, torch.bfloat16)
    with pytest.raises(ValueError, match="w_scale has shape"):
        i8._check(x, w, torch.ones(6), None, None, torch.bfloat16)


def test_int8_plain_reads_a_padded_weight_as_its_first_k_columns():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, 40, generator=gen)
    w = torch.randint(-127, 128, (9, 40), dtype=torch.int8, generator=gen)
    scale = torch.rand(9, generator=gen) * 1e-2
    args = (scale, 0.03, torch.randn(9, generator=gen), "gelu")
    torch.testing.assert_close(
        i8.int8_matmul_fused_plain(x, i8.pad_weight(w), *args),
        i8.int8_matmul_fused_plain(x, w, *args), rtol=0, atol=0)


def _detections(seed, n_gt=40, n_pred=300, classes=6, videos=4):
    rng = np.random.default_rng(seed)
    gs = rng.uniform(0, 60, n_gt)
    gt = {"video-id": np.asarray([f"v{i % 3}" for i in range(n_gt)],
                                 object),
          "t-start": gs, "t-end": gs + rng.uniform(0.5, 5, n_gt),
          "label": rng.integers(0, classes, n_gt)}
    ps = rng.uniform(0, 60, n_pred)
    pred = {"video-id": np.asarray([f"v{rng.integers(0, videos)}"
                                    for _ in range(n_pred)], object),
            "t-start": ps, "t-end": ps + rng.uniform(0, 6, n_pred),
            "label": rng.integers(0, classes + 1, n_pred),
            "score": rng.uniform(0, 1, n_pred)}
    return gt, pred


def _dump(seed, n=120, classes=5):
    rng = np.random.default_rng(seed)
    vids = np.asarray([f"v{i % 3}" for i in range(n)], object)
    start = rng.uniform(0, 50, n)
    props = np.stack([start, start + rng.uniform(0.5, 6, n)], -1)
    scores = rng.uniform(0, 0.3, (n, classes)).astype(np.float32)
    gs = rng.uniform(0, 50, 30)
    gt = pfp.gt_to_columns(np.asarray([f"v{i % 3}" for i in range(30)],
                                      object), gs,
                           gs + rng.uniform(1, 5, 30),
                           rng.integers(0, classes, 30))
    return vids, props, scores, gt


def test_n_jobs_without_joblib_equals_one_job_and_jax():
    """The workers of ``n_jobs = 2`` come from the standard library's
    process pool: with joblib blocked the evaluator's APs and
    ``evaluate_detections``' mAP and submission equal ``n_jobs = 1``'s and
    JAX's (whose ``n_jobs = 2`` takes joblib)."""
    gt, pred = _detections(3)
    vids, props, scores, dgt = _dump(4)
    kw = dict(score_threshold=0.1, num_nouns=3)
    want_ap = janet.DetectionEvaluator(gt, pred, n_jobs=2).evaluate()
    want_map = jfp.evaluate_detections(vids, props, scores, dgt, n_jobs=2,
                                       **kw)
    saved = sys.modules.get("joblib")
    sys.modules["joblib"] = None     # import joblib now raises
    try:
        for n_jobs in (1, 2):
            got = panet.DetectionEvaluator(gt, pred,
                                           n_jobs=n_jobs).evaluate()
            np.testing.assert_array_equal(got[0], want_ap[0])
            assert got[1] == want_ap[1]
            np.testing.assert_array_equal(got[2], want_ap[2])
            got_map = pfp.evaluate_detections(vids, props, scores, dgt,
                                              n_jobs=n_jobs, **kw)
            np.testing.assert_array_equal(got_map[0], want_map[0])
            assert got_map[1] == want_map[1] and got_map[1] > 0.0
            assert got_map[2] == want_map[2]
    finally:
        if saved is None:
            del sys.modules["joblib"]
        else:
            sys.modules["joblib"] = saved


def test_parallel_map_keeps_input_order():
    items = [(i,) for i in range(7)]
    assert panet.parallel_map(abs, [(-3,), (4,), (-5,)], 2) == [3, 4, 5]
    assert panet.parallel_map(float, items, 3) == [float(i) for i in
                                                   range(7)]
    assert panet.parallel_map(float, items, 1) == [float(i) for i in
                                                   range(7)]


@pytest.mark.parametrize("name,dh,c,ff", [("padded-head", 40, 80, 160),
                                          ("odd", 13, 52, 104)])
def test_width_cases_have_the_shapes_they_name(name, dh, c, ff):
    cfg = _cfg(*WIDTHS[name])
    assert (cfg.encoder_width // cfg.nhead, cfg.encoder_width,
            cfg.feedforward_scale * cfg.d_model) == (dh, c, ff)
